"""The port's stage-2 train path on the CPU against the JAX package: losses,
optimizer, BatchNorm statistics, the synthetic data, and one whole train
step of the tiny LIST (R 16, im_enc_layers (1,1,1,1,2,4,4,4), h_dim 8,
support 2, batch 2, 128 queries), whose weights reach the port through
``bridge.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from list_tpu.config import default_config as j_default_config
from list_tpu.data import SyntheticSDFDataset as JSyntheticSDFDataset
from list_tpu.data import collate as j_collate
from list_tpu.models import LIST as JLIST
from list_tpu.ops.losses import occupancy_loss as j_occ_loss
from list_tpu.ops.losses import sdf_loss as j_sdf_loss
from list_tpu.train import LISTExecutor as JExecutor
from list_tpu.train import total_loss as j_total_loss
from list_tpu.train.state import TrainState
from list_tpu.train.state import make_optimizer as j_make_optimizer
from list_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from list_tpu_torch.config import default_config
from list_tpu_torch.data import SyntheticSDFDataset, collate
from list_tpu_torch.models import LIST
from list_tpu_torch.models.norm import BatchNorm, checkpoint
from list_tpu_torch.ops.losses import occupancy_loss, sdf_loss
from list_tpu_torch.train import LISTExecutor, make_optimizer, total_loss

LR = 1e-3
CFG = dict(vox_res=16, img_res=32, sample_point_density=128,
           coarse_point_density=500, train_batch_size=2,
           point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
           im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
           test_pointnum=1024, lr=LR, remat=1, train_query_chunks=2)
TINY = dict(vox_res=16, point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4),
            im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)


# ---- losses -----------------------------------------------------------------

def test_losses_match_jax():
    """sdf_loss (with its ignore_ diagnostics) and occupancy_loss, values
    and gradients, with occupancy predictions at exactly 0 and 1 (the log
    arguments' clamp: finite values and gradients, and the gradient split
    at the clamp's tie as jnp.maximum splits it).  f32: rtol 1e-5."""
    rng = np.random.RandomState(0)
    pred = rng.randn(2, 64).astype(np.float32) * 3
    gt = rng.randn(2, 64).astype(np.float32) * 0.3
    occ = rng.rand(2, 6, 6, 6).astype(np.float32)
    occ.flat[:40] = 0.0
    occ.flat[40:80] = 1.0
    occ_gt = (rng.rand(2, 6, 6, 6) > 0.5).astype(np.float32)

    def j_total(p, o):
        d = j_sdf_loss(p, jnp.asarray(gt), 10.0)
        return j_total_loss(dict(d, occ_loss=j_occ_loss(o, occ_gt))), d

    (jv, jd), (jgp, jgo) = jax.value_and_grad(
        j_total, argnums=(0, 1), has_aux=True)(jnp.asarray(pred),
                                                jnp.asarray(occ))
    tp = torch.tensor(pred, requires_grad=True)
    to = torch.tensor(occ, requires_grad=True)
    td = sdf_loss(tp, torch.as_tensor(gt), 10.0)
    td['occ_loss'] = occupancy_loss(to, torch.as_tensor(occ_gt))
    tv = total_loss(td)
    tv.backward()
    assert set(td) == set(jd) | {'occ_loss'}
    for k in jd:
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert torch.isfinite(to.grad).all() and torch.isfinite(tp.grad).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-5)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jgo), rtol=1e-5)


# ---- optimizer ----------------------------------------------------------------

class _Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.enc = torch.nn.Linear(3, 4)
        self.dec = torch.nn.Linear(4, 2)


def test_optimizer_matches_optax_with_frozen_prefix():
    """Two Adam steps (coupled weight decay) against the JAX package's
    optax chain with 'enc' frozen: the frozen submodule does not move, the
    rest agrees at atol 1e-6 (f32)."""
    rng = np.random.RandomState(1)
    m = _Two()
    w = {k: rng.randn(*p.shape).astype(np.float32)
         for k, p in m.named_parameters()}
    grads = [{k: rng.randn(*a.shape).astype(np.float32) for k, a in w.items()}
             for _ in range(2)]
    m.load_state_dict({k: torch.as_tensor(a) for k, a in w.items()})
    opt = make_optimizer(m.named_parameters(), LR, weight_decay=1e-2,
                         frozen_prefixes=('enc',))
    nest = lambda d: {'enc': {'w': d['enc.weight'], 'b': d['enc.bias']},  # noqa
                      'dec': {'w': d['dec.weight'], 'b': d['dec.bias']}}
    tx = j_make_optimizer(LR, weight_decay=1e-2, frozen_prefixes=('enc',))
    params = jax.tree.map(jnp.asarray, nest(w))
    state = tx.init(params)
    for g in grads:
        for k, p in m.named_parameters():
            p.grad = torch.as_tensor(g[k])
        opt.step()
        upd, state = tx.update(jax.tree.map(jnp.asarray, nest(g)), state,
                               params)
        params = jax.tree.map(lambda a, u: a + u, params, upd)
        got = nest({k: p.detach().numpy() for k, p in m.named_parameters()})
        for part in ('enc', 'dec'):
            for leaf in ('w', 'b'):
                np.testing.assert_allclose(got[part][leaf],
                                           np.asarray(params[part][leaf]),
                                           atol=1e-6)
    np.testing.assert_array_equal(m.enc.weight.detach().numpy(),
                                  w['enc.weight'])


# ---- BatchNorm ----------------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 5), (2, 3, 4, 4), (2, 2, 3, 3, 3)])
def test_batchnorm_matches_flax(shape):
    """Two training updates at batch 2 and an eval pass: outputs and
    running statistics (flax's 0.9*old + 0.1*batch with the biased
    variance) against nn.BatchNorm(momentum=0.9): atol 1e-5 (f32)."""
    rng = np.random.RandomState(len(shape))
    c = shape[1]
    xs = [(rng.randn(*shape) * 2 + 0.5).astype(np.float32) for _ in range(3)]
    to_cl = lambda a: np.moveaxis(a, 1, -1)  # noqa: E731
    jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(to_cl(xs[0])),
                use_running_average=False)
    v = {'params': {'scale': jnp.asarray(rng.rand(c) + 0.5, jnp.float32),
                    'bias': jnp.asarray(rng.randn(c), jnp.float32)},
         'batch_stats': v['batch_stats']}
    bn = BatchNorm(c)
    load_flax_variables(bn, jax.tree.map(np.asarray, v))
    bn.train()
    for x in xs[:2]:
        ref, upd = jm.apply(v, jnp.asarray(to_cl(x)),
                            use_running_average=False, mutable=['batch_stats'])
        v = {'params': v['params'], 'batch_stats': upd['batch_stats']}
        with torch.no_grad():
            got = bn(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(to_cl(got), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(v['batch_stats']['mean']),
                                   atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(v['batch_stats']['var']),
                                   atol=1e-5)
    bn.eval()
    ref = jm.apply(v, jnp.asarray(to_cl(xs[2])), use_running_average=True)
    with torch.no_grad():
        got = bn(torch.as_tensor(xs[2])).numpy()
    np.testing.assert_allclose(to_cl(got), np.asarray(ref), atol=1e-5)


def test_batchnorm_updates_once_under_checkpoint():
    """Under ``checkpoint`` the backward recomputes the forward; the
    running statistics still take exactly one update, and the gradients
    equal the plain run's."""
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 3, 4, 4).astype(np.float32))
    r = torch.tensor(rng.randn(2, 3, 4, 4).astype(np.float32))
    plain, ckpt = BatchNorm(3), BatchNorm(3)
    plain.train()
    ckpt.train()
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    (plain(xa) * r).sum().backward()
    (checkpoint(ckpt, xb) * r).sum().backward()
    for a, b in ((plain.running_mean, ckpt.running_mean),
                 (plain.running_var, ckpt.running_var),
                 (xa.grad, xb.grad), (plain.weight.grad, ckpt.weight.grad)):
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    assert not torch.equal(plain.running_var, torch.ones(3))


# ---- data ---------------------------------------------------------------------

def test_synthetic_dataset_is_the_jax_packages():
    """The copied SyntheticSDFDataset and collate give the JAX package's
    batch, array for array."""
    kw = dict(CFG, sample_point_density=64)
    a = JSyntheticSDFDataset(j_default_config(**kw), 'train', n_shapes=2)
    b = SyntheticSDFDataset(default_config(**kw), 'train', n_shapes=2)
    got, ref = collate([b[0], b[1]]), j_collate([a[0], a[1]])
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ---- the whole step -------------------------------------------------------------

def _seeded_variables(jm, img_shape, seed=7):
    """The JAX LIST's variable tree (shapes from jax.eval_shape of its
    init) filled from a numpy seed: kernels uniform in +-1/sqrt(fan_in)
    (torch's default scale), small biases, BatchNorm scales near 1 and
    non-trivial running statistics."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(img_shape[1:])),
                            jnp.zeros((1, 8, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        u = rng.uniform(-1.0, 1.0, s.shape)
        if leaf == 'mean':
            a = 0.1 * u
        elif leaf == 'var':
            a = 1.0 + 0.2 * np.abs(u)
        elif leaf == 'scale':
            a = 1.0 + 0.1 * u
        elif leaf == 'bias':
            a = 0.1 * u
        elif leaf == 'W_branch':  # (node, in, degree * in)
            a = u / np.sqrt(s.shape[1])
        else:  # kernels: (..., in, out)
            a = u / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope='module')
def setup():
    """The tiny batch (port dataset), the JAX package's LISTExecutor (its
    calc_loss and _train_keys) and seeded initial variables."""
    cfg = default_config(**CFG)
    ds = SyntheticSDFDataset(cfg, 'train', n_shapes=2)
    batch = collate([ds[0], ds[1]])
    jex = JExecutor(j_default_config(**CFG),
                    JLIST(**TINY, train_query_chunks=2))
    return cfg, batch, jex, _seeded_variables(jex.model,
                                              batch['rgb_image'].shape)


def _jax_step(jex, jm, variables, batch, dtype):
    """The JAX LISTExecutor's loss function (executors.py loss_fn under
    jax.value_and_grad) and one apply_gradients, in ``dtype``."""
    keep = jex._train_keys(batch)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa
    params, stats = cast(variables['params']), cast(variables['batch_stats'])
    img, pts, vals = (jnp.asarray(keep[k], dtype)
                      for k in ('rgb_image', 'points', 'values'))
    occ = jnp.asarray(keep['occ']).astype(jnp.float32)

    def loss_fn(p):
        (occ_pred, sdf_pred), upd = jm.apply(
            {'params': p, 'batch_stats': stats}, img, pts, None, True,
            mutable=['batch_stats'])
        losses = jex.calc_loss((occ_pred, sdf_pred), (occ, vals))
        return j_total_loss(losses), (losses, upd['batch_stats'])

    (_, (losses, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = TrainState.create(params, stats,
                              j_make_optimizer(LR, weight_decay=1e-5))
    state = jax.jit(lambda s, g, n: s.apply_gradients(g, new_batch_stats=n))(
        state, grads, new_stats)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return ({k: float(v) for k, v in losses.items()},
            flax_to_state_dict({'params': np_(grads)}),
            flax_to_state_dict({'params': np_(state.params),
                                'batch_stats': np_(state.batch_stats)}))


def _port_step(tex, batch):
    """The port executor's step (``LISTExecutor.train``) in the dtype of
    its model's parameters."""
    _, losses = tex.train(batch)
    grads = {k: None if p.grad is None else p.grad.numpy()
             for k, p in tex.model.named_parameters()}
    return ({k: float(v) for k, v in losses.items()}, grads,
            {k: v.numpy() for k, v in tex.model.state_dict().items()})


@pytest.fixture(scope='module')
def step64(setup):
    """One step in float64 on both sides, with the features kept in the
    compute dtype (``vox_packed_dtype=None`` on both): the algorithm,
    compared tightly.  (The bf16 fold-pack cast makes the JAX package
    scatter-add the feature gradients in bf16; the port rounds them once.)
    The port runs remat (encoder and decode chunks), the JAX package
    without: the same step."""
    cfg, batch, jex, variables = setup
    with jax.enable_x64(True):
        ref = _jax_step(jex, JLIST(**TINY, train_query_chunks=2,
                                   vox_packed_dtype=None),
                        variables, batch, jnp.float64)
    tm = LIST(**TINY, remat=True, train_query_chunks=2,
              vox_packed_dtype=None)
    load_flax_variables(tm, variables)
    tex = LISTExecutor(cfg, tm.double(), device='cpu')
    return ref, _port_step(tex, batch)


@pytest.fixture(scope='module')
def step32(setup):
    """One step in float32 with the production bf16 feature cast, the
    port (with remat) through ``LISTExecutor.train``."""
    cfg, batch, jex, variables = setup
    ref = _jax_step(jex, jex.model, variables, batch, jnp.float32)
    tm = LIST(**TINY, remat=True, train_query_chunks=2)
    load_flax_variables(tm, variables)
    tex = LISTExecutor(cfg, tm, device='cpu')
    return ref, _port_step(tex, batch), tex


def test_step_f64_losses(step64):
    """sdf losses at rtol 1e-9 (f64); occ_loss at rtol 1e-5: both packages
    compute it in f32 (the JAX package casts occ_pred to f32)."""
    (jl, _, _), (tl, _, _) = step64
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k],
                                   rtol=1e-5 if k == 'occ_loss' else 1e-9)


def test_step_f64_every_gradient(step64):
    """Every parameter's gradient, f64: |port - jax| <= 1e-10 + 1e-4 *
    max|jax| per parameter.  Both packages compute the occupancy loss in
    f32 (the JAX package casts occ_pred to f32); its per-voxel gradients
    (up to ~1e5 where p is near 0 or 1) differ in the last f32 bit and
    cancel in the voxel encoder's sums: measured 2.7e-5 relative there,
    <= 2e-6 elsewhere.  The conv biases before point_mlp's BatchNorms have
    an exact gradient of zero and come out at ~1e-13."""
    (_, jg, _), (_, tg, _) = step64
    assert set(tg) == set(jg)
    bad = []
    for k, a in jg.items():
        b = tg[k]
        if b is None or not np.isfinite(b).all() or \
                np.abs(b - a).max() > 1e-10 + 1e-4 * np.abs(a).max():
            bad.append((k, None if b is None else np.abs(b - a).max(),
                        np.abs(a).max()))
    assert not bad, bad


def _state_errors(j_sd, t_sd, lr_bound):
    """Worst differences of the updated params and batch stats."""
    out = {'params': [], 'stats': [], 'moved': []}
    for k, a in j_sd.items():
        d = np.abs(t_sd[k] - a)
        out['stats' if 'running' in k else 'params'].append((d.max(), k))
        if 'running' not in k:
            out['moved'].append(((d > lr_bound).mean(), k))
    return {k: max(v) for k, v in out.items()}


def test_step_f64_params_and_batch_stats(step64):
    """After one Adam step (lr 1e-3), f64.  Adam's first step moves each
    element by about lr * sign(g): where a gradient component is within
    the f32 occupancy-loss rounding of zero the sign can flip, so params
    agree within 2 * lr + 1e-9, and at most 1% of any parameter's elements
    differ by more than 1e-6.  Batch stats: atol 1e-9."""
    (_, _, jsd), (_, _, tsd) = step64
    err = _state_errors(jsd, tsd, 1e-6)
    assert err['params'][0] <= 2 * LR + 1e-9, err
    assert err['moved'][0] <= 0.01, err
    assert err['stats'][0] <= 1e-9, err


def test_step_f32_losses_and_gradients(step32):
    """Production dtype (f32, bf16 feature cast) through
    LISTExecutor.train.  Losses at rtol 2e-3: the spatial transformer's
    BatchNorm1d normalizes over a batch of 2, which amplifies f32 rounding
    (trans_mat differs by ~1.7e-3 relative between the packages), and that
    moves the perceptual samples.  Every gradient is present and finite,
    and non-zero wherever the JAX package's is."""
    (jl, jg, _), (tl, tg, _), _ = step32
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=2e-3, err_msg=k)
    for k, a in jg.items():
        assert tg[k] is not None and np.isfinite(tg[k]).all(), k
        if np.abs(a).max() > 1e-6:
            assert np.abs(tg[k]).max() > 0, k


def test_step_f32_params_and_batch_stats(step32, step64):
    """f32 after one step: params within 2 * lr + 1e-5 of the JAX
    package's f32 step (Adam's sign flips, as above).  Batch stats are held
    against the f64 step's (exact) statistics, not against flax's f32 ones:
    flax computes the variance as E[x^2] - E[x]^2 in f32, which at the
    spatial transformer's batch of 2 loses digits, by how many depends on
    the host's f32 reductions.  Measured on a CPU: the port 1.2e-4 off,
    flax 1.19e-3 (both at spatial_transformer.bn1.running_var); bounds
    1e-3 for the port and 1e-2 for flax."""
    (_, _, jsd), (_, _, tsd), _ = step32
    err = _state_errors(jsd, tsd, 1e-5)
    assert err['params'][0] <= 2 * LR + 1e-5, err
    (_, _, ref), _ = step64
    port = _state_errors(ref, tsd, 1e-5)['stats']
    flax = _state_errors(ref, jsd, 1e-5)['stats']
    assert port[0] <= 1e-3, port
    assert flax[0] <= 1e-2, flax


def test_executor_train_state(step32, setup):
    """train(): (None, losses) with the JAX package's keys, the step
    counter, eval mode after the step, step_s, and the uint8 occupancy
    wire."""
    _, (tl, _, _), tex = step32
    _, batch, _, _ = setup
    assert set(tl) == {'occ_loss', 'sdf_loss', 'ignore_sdf_loss_realvalue',
                       'ignore_sdf_accuracy'}
    assert tex.step == 1 and not tex.model.training
    assert tex.timings['step_s'] > 0
    assert tex._train_keys(batch)['occ'].dtype == np.uint8


# ---- remat, chunking, several steps ---------------------------------------------

@pytest.fixture(scope='module')
def port_runs(setup):
    """One ``LISTExecutor.train`` step per (remat, chunks), in f64
    (upstream of the spatial transformer's batch-2 BatchNorm1d an f32
    gradient is too ill-conditioned to compare two summation orders)."""
    cfg, batch, _, variables = setup

    def run(remat, chunks):
        tm = LIST(**TINY, remat=bool(remat), train_query_chunks=chunks)
        load_flax_variables(tm, variables)
        tex = LISTExecutor(cfg, tm.double(), device='cpu')
        _, losses = tex.train(batch)
        return ({k: float(v) for k, v in losses.items()},
                {k: p.grad.clone() for k, p in tm.named_parameters()},
                {k: v.clone() for k, v in tm.state_dict().items()
                 if 'running' in k})

    return run, run(0, 1)


@pytest.mark.parametrize('remat,chunks', [(1, 1), (0, 2), (1, 2), (1, 3),
                                          (0, 4), (1, 4)])
def test_remat_and_query_chunks_same_step(port_runs, remat, chunks):
    """remat on/off and train_query_chunks 1/2/3 (a ragged, zero-padded
    tail)/4 give the plain run's losses (rtol 1e-9), gradients (atol
    1e-10 + 1e-6 * max|g|: the chunks' gradients add in another order) and
    batch stats updated exactly once (atol 1e-12), in f64."""
    run, (l0, g0, s0) = port_runs
    l1, g1, s1 = run(remat, chunks)
    for k in l0:
        np.testing.assert_allclose(l1[k], l0[k], rtol=1e-9, err_msg=k)
    for k in g0:
        tol = 1e-10 + 1e-6 * float(g0[k].abs().max())
        assert float((g1[k] - g0[k]).abs().max()) <= tol, k
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], atol=1e-12, rtol=0)


def test_train_multi_and_frozen_prefixes(setup):
    """train_multi runs one step per batch (the losses of K single steps,
    as (K,) arrays); frozen submodules keep their weights while their
    BatchNorm statistics update."""
    cfg, batch, _, variables = setup

    def make():
        tm = LIST(**TINY, remat=True, train_query_chunks=2)
        load_flax_variables(tm, variables)
        return LISTExecutor(cfg, tm, device='cpu')

    single = make()
    l1 = [single.train(batch)[1] for _ in range(2)]
    multi = make()
    _, lm = multi.train_multi([batch, batch])
    for k in lm:
        assert lm[k].shape == (2,)
        np.testing.assert_allclose(lm[k].numpy(), [float(d[k]) for d in l1],
                                   rtol=1e-6)
    frozen = make()
    frozen.init_optimizer(frozen_prefixes=('im_encoder', 'point_decoder'))
    before = {k: v.clone() for k, v in frozen.model.state_dict().items()}
    frozen.train(batch)
    after = frozen.model.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        if k.startswith(('im_encoder.', 'point_decoder.')):
            assert moved == ('running' in k), k
    assert not torch.equal(after['sdf_decoder.fc_0.weight'],
                           before['sdf_decoder.fc_0.weight'])
