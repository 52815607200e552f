"""Stage 1 of the port on the CPU against the JAX package: the Chamfer
loss, the CoarseNet forward and one whole ``CoarseNetExecutor.train`` step
of the tiny CoarseNet (ResNet18, point_feat (128, 8, 8, 3), degrees
(2, 2, 4), 32x32 images, batch 2), whose weights reach the port through
``bridge.py``; and the training data: the synthetic ShapeNet tree, the
augmentations, both ShapeNet readers' train items and the loader."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.config import default_config as j_default_config
from list_tpu.data import DataLoader as JDataLoader
from list_tpu.data import IM2PointFarthest as JIM2PointFarthest
from list_tpu.data import IM2SDF as JIM2SDF
from list_tpu.data import ImageTransform as JImageTransform
from list_tpu.data import generate_synthetic_shapenet as j_generate
from list_tpu.models import CoarseNet as JCoarseNet
from list_tpu.ops.losses import chamfer_distance as j_chamfer_distance
from list_tpu.ops.losses import chamfer_loss as j_chamfer_loss
from list_tpu.train.state import TrainState
from list_tpu.train.state import make_optimizer as j_make_optimizer
from list_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from list_tpu_torch.config import default_config
from list_tpu_torch.data import (DataLoader, IM2PointFarthest, IM2SDF,
                                 ImageTransform, generate_synthetic_shapenet)
from list_tpu_torch.models import CoarseNet
from list_tpu_torch.ops.losses import chamfer_distance, chamfer_loss
from list_tpu_torch.train.executors import CoarseNetExecutor

LR = 1e-3
TINY = dict(point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4))
CFG = dict(img_res=32, train_batch_size=2, lr=LR,
           point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4])


# ---- the Chamfer loss -------------------------------------------------------

def test_chamfer_matches_jax():
    """chamfer_distance and chamfer_loss values at rtol 1e-5 and the
    loss's gradients with respect to both clouds at atol 1e-5 of their
    scale (f32; the JAX package's matmul at HIGHEST precision, the port's
    with TF32 off)."""
    rng = np.random.RandomState(0)
    x = (rng.rand(2, 50, 3) - 0.5).astype(np.float32)
    y = (rng.rand(2, 70, 3) - 0.5).astype(np.float32)
    jd = float(j_chamfer_distance(jnp.asarray(x), jnp.asarray(y)))
    jv, (jgx, jgy) = jax.value_and_grad(j_chamfer_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(
        float(chamfer_distance(torch.as_tensor(x), torch.as_tensor(y))), jd,
        rtol=1e-5)
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    tv = chamfer_loss(tx, ty)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for got, ref in ((tx.grad, jgx), (ty.grad, jgy)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


# ---- the model and one step -------------------------------------------------

def _seeded_variables(jm, img_shape, seed=5):
    """The JAX CoarseNet's variable tree filled from a numpy seed: kernels
    uniform in +-1/sqrt(fan_in), small biases, BatchNorm scales near 1 and
    non-trivial running statistics."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + tuple(img_shape[1:])))
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
        elif leaf == 'W_branch':
            a = u / np.sqrt(s.shape[1])
        else:
            a = u / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope='module')
def setup():
    """A batch of two 32x32 images with 300-point target clouds, the JAX
    CoarseNet and seeded variables."""
    rng = np.random.RandomState(3)
    batch = {'rgb_image': rng.rand(2, 32, 32, 3).astype(np.float32),
             'pc': (rng.rand(2, 300, 3) - 0.5).astype(np.float32)}
    jm = JCoarseNet(**TINY)
    return batch, jm, _seeded_variables(jm, batch['rgb_image'].shape)


def test_forward_matches_jax(setup):
    """Eval-mode forward (running statistics): (2, 16, 3) at atol 1e-5
    (f32)."""
    batch, jm, v = setup
    ref = np.asarray(jm.apply(v, jnp.asarray(batch['rgb_image'])))
    tm = CoarseNet(**TINY)
    load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(batch['rgb_image'])).numpy()
    assert got.shape == ref.shape == (2, 16, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _jax_step(jm, variables, batch, dtype):
    """The JAX CoarseNetExecutor's step (executors.py loss_fn under
    jax.value_and_grad, then apply_gradients) in ``dtype``."""
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa
    params, stats = cast(variables['params']), cast(variables['batch_stats'])
    img, pc = (jnp.asarray(batch[k], dtype) for k in ('rgb_image', 'pc'))

    def loss_fn(p):
        pred, upd = jm.apply({'params': p, 'batch_stats': stats}, img,
                             train=True, mutable=['batch_stats'])
        return j_chamfer_loss(pred, pc), upd['batch_stats']

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = TrainState.create(params, stats,
                              j_make_optimizer(LR, weight_decay=1e-5))
    state = jax.jit(lambda s, g, n: s.apply_gradients(g, new_batch_stats=n))(
        state, grads, new_stats)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (float(loss), flax_to_state_dict({'params': np_(grads)}),
            flax_to_state_dict({'params': np_(state.params),
                                'batch_stats': np_(state.batch_stats)}))


def _port_step(variables, batch, dtype):
    tm = CoarseNet(**TINY)
    load_flax_variables(tm, variables)
    ex = CoarseNetExecutor(default_config(**CFG), tm.to(dtype), device='cpu')
    _, losses = ex.train(batch)
    grads = {k: None if p.grad is None else p.grad.numpy()
             for k, p in ex.model.named_parameters()}
    return (float(losses['chamfer_loss']), grads,
            {k: v.numpy() for k, v in ex.model.state_dict().items()}, ex)


@pytest.fixture(scope='module')
def step64(setup):
    batch, jm, v = setup
    with jax.enable_x64(True):
        ref = _jax_step(jm, v, batch, jnp.float64)
    return ref, _port_step(v, batch, torch.float64)


def test_step_f64_loss_and_every_gradient(step64):
    """f64 on both sides: the loss at rtol 1e-10, every parameter's
    gradient within 1e-12 + 1e-7 * max|jax| of the JAX package's."""
    (jl, jg, _), (tl, tg, _, _) = step64
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    assert set(tg) == set(jg)
    bad = [(k, np.abs(tg[k] - a).max(), np.abs(a).max())
           for k, a in jg.items()
           if tg[k] is None or
           np.abs(tg[k] - a).max() > 1e-12 + 1e-7 * np.abs(a).max()]
    assert not bad, bad


def test_step_f64_params_and_batch_stats(step64):
    """After one Adam step (lr 1e-3), f64: params within 1e-9 (Adam's
    first step is lr * g / |g| per element; both packages' gradients agree
    to 1e-7 of their scale, no element's sign flips here) and the
    BatchNorm running statistics within 1e-12."""
    (_, _, jsd), (_, _, tsd, _) = step64
    for k, a in jsd.items():
        tol = 1e-12 if 'running' in k else 1e-9
        np.testing.assert_allclose(tsd[k], a, rtol=0, atol=tol, err_msg=k)


def test_step_f32_and_executor_state(setup):
    """Production dtype (f32): the loss at rtol 1e-4 of the JAX package's
    f32 step and every gradient present and finite; the step's keys, the
    step counter, eval mode after the step and step_s."""
    batch, jm, v = setup
    jl, _, _ = _jax_step(jm, v, batch, jnp.float32)
    tl, tg, _, ex = _port_step(v, batch, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(g is not None and np.isfinite(g).all() for g in tg.values())
    assert ex.step == 1 and not ex.model.training
    assert ex.timings['step_s'] > 0
    _, losses = ex.train_multi([batch, batch])
    assert set(losses) == {'chamfer_loss'} and losses['chamfer_loss'].shape \
        == (2,) and ex.step == 3


def test_test_eval_and_save(setup, tmp_path):
    """test(): the predicted cloud of one image (as the JAX package's
    predict) and, with eval_pred, eval_pointcloud against the target's
    cloud resampled to the prediction's size; save() writes the vertices
    as an .obj."""
    batch, jm, v = setup
    tm = CoarseNet(**TINY)
    load_flax_variables(tm, v)
    ex = CoarseNetExecutor(default_config(**CFG), tm, device='cpu')
    one = (batch['rgb_image'][:1], batch['pc'][:1])
    pred, score = ex.test(one, eval_pred=True)
    ref = np.asarray(jm.apply(v, jnp.asarray(one[0])))
    np.testing.assert_allclose(pred, ref, atol=1e-5)
    assert 'chamfer_l2' in score and np.isfinite(score['chamfer_l2'])
    ex.save(one, pred, str(tmp_path / 'x'))
    lines = (tmp_path / 'x_pred.obj').read_text().splitlines()
    assert sum(line.startswith("v ") for line in lines) == 16


# ---- the training data ------------------------------------------------------

def _data_cfg(root, pkg_default_config, **kw):
    base = dict(image_dir=os.path.join(root, 'images') + '/',
                h5_dir=os.path.join(root, 'sampled_points') + '/',
                mesh_dir=os.path.join(root, 'mesh') + '/',
                split_dir=os.path.join(root, 'split'),
                catlist=['03001627'], viewnum=2, vox_res=16,
                sample_point_density=128, coarse_point_density=1000,
                sample_distribution=[0.45, 0.44, 0.1], random_h_flip=True,
                color_jitter=True, normalize=True)
    base.update(kw)
    return pkg_default_config(**base)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The same seeded ShapeNet-format tree written by both packages."""
    out = {}
    for name, gen in (('jax', j_generate),
                      ('port', generate_synthetic_shapenet)):
        root = str(tmp_path_factory.mktemp(name))
        ids = gen(root, cats=('03001627',), n_shapes=2, n_views=2,
                  img_res=32, n_surface=1200)
        out[name] = (root, ids)
    return out


def test_synthetic_tree_matches_jax(trees):
    """generate_synthetic_shapenet writes the JAX package's tree: the same
    ids, files, images, h5 datasets and meshes."""
    import h5py
    (jr, jids), (tr, tids) = trees['jax'], trees['port']
    assert jids == tids
    files = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)  # noqa
                             for d, _, fs in os.walk(r) for f in fs)
    assert files(jr) == files(tr)
    for rel in files(jr):
        a, b = os.path.join(jr, rel), os.path.join(tr, rel)
        if rel.endswith('.h5'):
            with h5py.File(a, 'r') as fa, h5py.File(b, 'r') as fb:
                assert sorted(fa) == sorted(fb)
                for k in fa:
                    np.testing.assert_array_equal(fa[k][:], fb[k][:])
        else:
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), rel


def test_image_transform_matches_jax():
    """ImageTransform (flip, colour jitter in random order, normalize,
    resize) under one seeded generator: identical to the JAX package's."""
    img = (np.random.RandomState(4).rand(40, 40, 3) * 255).astype(np.uint8)
    for kw in (dict(random_h_flip=True, color_jitter=True, normalize=True),
               dict(random_h_flip=True, resize_to=32)):
        a, b = JImageTransform(**kw), ImageTransform(**kw)
        ga, gb = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(4):
            np.testing.assert_array_equal(b(img, gb), a(img, ga))


@pytest.mark.parametrize('name', ['IM2PointFarthest', 'IM2SDF'])
def test_train_items_match_jax(trees, name):
    """Both readers' train items (augmented image, FPS cloud; or queries,
    SDF values and occupancy from ensure_occupancies' cache) in the JAX
    package's order of the seeded generator: identical."""
    J = {'IM2PointFarthest': JIM2PointFarthest, 'IM2SDF': JIM2SDF}[name]
    T = {'IM2PointFarthest': IM2PointFarthest, 'IM2SDF': IM2SDF}[name]
    jd = J(_data_cfg(trees['jax'][0], j_default_config), 'train')
    td = T(_data_cfg(trees['port'][0], default_config), 'train')
    if name == 'IM2SDF':
        jd.ensure_occupancies()
        td.ensure_occupancies()
    assert len(td) == len(jd) == 2
    for i in (0, 1, 1, 0):
        a, b = jd[i], td[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    a = jd.get_testdata('03001627', jd.datalist[0]['shape_id'], 0)
    b = td.get_testdata('03001627', td.datalist[0]['shape_id'], 0)
    if name == 'IM2SDF':
        np.testing.assert_array_equal(b['rgb_image'], a['rgb_image'])
    else:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


class _Items:
    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f'item {i}')
        return {'i': np.asarray(i), 'x': np.full(3, i, np.float32)}


def test_loader_matches_jax():
    """DataLoader under one seed: the JAX package's batches in the JAX
    package's order over two epochs (threaded, shuffled, drop_last), and
    an item's error is raised to the consumer."""
    for kw in (dict(batch_size=3, num_workers=3),
               dict(batch_size=4, num_workers=1, drop_last=False)):
        a, b = JDataLoader(_Items(10), seed=7, **kw), \
            DataLoader(_Items(10), seed=7, **kw)
        assert len(a) == len(b)
        for _ in range(2):
            ja, tb = list(a), list(b)
            assert len(ja) == len(tb) == len(a)
            for x, y in zip(ja, tb):
                np.testing.assert_array_equal(y['i'], x['i'])
                np.testing.assert_array_equal(y['x'], x['x'])
    with pytest.raises(KeyError, match='item 4'):
        list(DataLoader(_Items(10, bad=4), batch_size=2, shuffle=False))
