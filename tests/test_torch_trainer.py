"""The port's training driver on the CPU against the JAX package: the
msgpack writer and the inverse bridge, checkpoints with Adam state in both
formats (resume, and a port-written ``.ckpt`` that ``list_tpu`` runs),
submodule checkpoints and ``split_coarse``, ``--resnet_ckpt``, and the
two-stage recipe through ``train_torch.py`` -> ``split_coarse`` ->
``train`` -> ``infer_torch.py`` on the port's own synthetic tree, at
``tests/test_e2e.py``'s tiny sizes."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.config import default_config as j_default_config
from list_tpu.models import CoarseNet as JCoarseNet
from list_tpu.ops.losses import chamfer_loss as j_chamfer_loss
from list_tpu.train import CoarseNetExecutor as JCoarseNetExecutor
from list_tpu.train import checkpoints as j_ckpt
from list_tpu.train.split_coarse import split_coarse_checkpoint as j_split
from list_tpu.train.state import TrainState
from list_tpu.train.state import make_optimizer as j_make_optimizer
from list_tpu.utils.torch_port import apply_resnet_ckpt as j_apply_resnet
from list_tpu_torch.bridge import (flax_to_state_dict, load_flax_variables,
                                   state_dict_to_flax)
from list_tpu_torch.config import default_config
from list_tpu_torch.models import LIST, CoarseNet
from list_tpu_torch.train import checkpoints as ckpt
from list_tpu_torch.train.executors import CoarseNetExecutor
from list_tpu_torch.train.split_coarse import split_coarse_checkpoint
from list_tpu_torch.utils import flax_msgpack
from list_tpu_torch.utils.torch_port import apply_resnet_ckpt

LR = 1e-3
TINY = dict(point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4))
CFG = dict(img_res=32, train_batch_size=2, lr=LR,
           point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4])
LIST_TINY = dict(vox_res=16, point_feat=(128, 8, 8, 3),
                 point_degree=(2, 2, 4),
                 im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    return {'rgb_image': rng.rand(2, 32, 32, 3).astype(np.float32),
            'pc': (rng.rand(2, 300, 3) - 0.5).astype(np.float32)}


def _same(a, b):
    """Two nested trees of arrays: the same keys and equal leaves."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), \
            (sorted(a), sorted(b) if isinstance(b, dict) else b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---- the msgpack writer and the inverse bridge ------------------------------

def test_msgpack_writer_is_flax(monkeypatch):
    """msgpack_serialize gives flax's bytes: sorted keys, every int width,
    floats, str, bytes, None, bools, arrays and numpy scalars, a bf16
    leaf from a torch tensor, and arrays chunked over MAX_CHUNK_SIZE."""
    rng = np.random.RandomState(0)
    bf = jnp.asarray(rng.randn(40), jnp.bfloat16)
    tree = {'z': {'b': rng.randn(3, 4).astype(np.float32), 'a': {}},
            'ints': [1, -5, 200, -200, 70000, -70000, 2 ** 40, -2 ** 40],
            'f': 0.25, 's': 'x' * 40, 'by': b'\x00\xff', 'n': None,
            't': True, 'c': np.asarray(3, np.int32), 'sc': np.float32(2.5),
            'e': np.zeros((0, 3), np.int64),
            'many': {str(i): i for i in range(20)}}
    assert flax_msgpack.msgpack_serialize(tree) == \
        flax.serialization.msgpack_serialize(tree)
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 16)
    monkeypatch.setattr(flax_msgpack, 'MAX_CHUNK_SIZE', 16)
    bits = torch.from_numpy(np.asarray(bf).view(np.int16).copy())
    w = rng.randn(50).astype(np.float32)
    ref = flax.serialization.msgpack_serialize({'w': w, 'bf': np.asarray(bf)})
    got = flax_msgpack.msgpack_serialize({'w': w,
                                          'bf': bits.view(torch.bfloat16)})
    assert got == ref
    _same(flax.serialization.msgpack_restore(ref),
          {k: (v.view(torch.int16).numpy().view(jnp.bfloat16)
               if isinstance(v, torch.Tensor) else v)
           for k, v in flax_msgpack.msgpack_restore(got).items()})


@pytest.mark.parametrize('which', ['CoarseNet', 'LIST'])
def test_state_dict_to_flax_is_the_jax_tree(which):
    """The inverse bridge gives the JAX model's variable tree (keys and
    shapes of its init) and round-trips through the bridge exactly."""
    if which == 'CoarseNet':
        jm, tm = JCoarseNet(**TINY), CoarseNet(**TINY)
        args = (jnp.zeros((1, 32, 32, 3)),)
    else:
        from list_tpu.models import LIST as JLIST
        jm, tm = JLIST(**LIST_TINY), LIST(**LIST_TINY)
        args = (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 8, 3)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    tree = state_dict_to_flax(tm.state_dict())
    _same(jax.tree.map(lambda s: np.asarray(s.shape), shapes),
          jax.tree.map(lambda a: np.asarray(a.shape), tree))
    sd = flax_to_state_dict(tree)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy())


# ---- checkpoints with Adam state --------------------------------------------

def _jax_state(variables, dtype, frozen=()):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa
    return TrainState.create(cast(variables['params']),
                             cast(variables['batch_stats']),
                             j_make_optimizer(LR, weight_decay=1e-5,
                                              frozen_prefixes=frozen))


def _jax_stepper(jm):
    """One JAX CoarseNet step (the executor's loss_fn under
    jax.value_and_grad, then apply_gradients), jitted."""
    def step(state, img, pc):
        def loss_fn(p):
            pred, upd = jm.apply(
                {'params': p, 'batch_stats': state.batch_stats}, img,
                train=True, mutable=['batch_stats'])
            return j_chamfer_loss(pred, pc), upd['batch_stats']

        (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads, new_batch_stats=stats)

    return jax.jit(step)


@pytest.fixture(scope='module')
def jax_ckpt(tmp_path_factory):
    """A JAX CoarseNet in f64 after one Adam step, saved with its Adam
    state; and the state after one more step from the same file."""
    jm = JCoarseNet(**TINY)
    data = lambda b: (jnp.asarray(b['rgb_image'], jnp.float64),  # noqa
                      jnp.asarray(b['pc'], jnp.float64))
    with jax.enable_x64(True):
        v = jax.jit(jm.init)(jax.random.PRNGKey(1),
                             jnp.zeros((1, 32, 32, 3)))
        step = _jax_stepper(jm)
        state = step(_jax_state(v, jnp.float64), *data(_batch()))
        path = str(tmp_path_factory.mktemp('ckpt') / 'j.ckpt')
        j_ckpt.save_checkpoint(4, state, 0.5, path)
        _, fresh, _ = j_ckpt.load_checkpoint(
            path, _jax_state(v, jnp.float64))
        after = step(fresh, *data(_batch(4)))
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return path, flax_to_state_dict({'params': np_(after.params),
                                     'batch_stats': np_(after.batch_stats)})


def _port_resume(path, restore_opt):
    model = CoarseNet(**TINY).double()
    ex = CoarseNetExecutor(default_config(**CFG), model, device='cpu')
    ex.init_optimizer()
    epoch, best, ex.step = ckpt.load_checkpoint(
        path, model, with_step=True,
        optimizer=ex.optimizer if restore_opt else None)
    ex.train(_batch(4))
    return (epoch, best, ex.step), {k: v.numpy()
                                    for k, v in model.state_dict().items()}


def test_resume_from_a_jax_checkpoint(jax_ckpt):
    """Weights, Adam's count/mu/nu, epoch, bestloss and step from a JAX
    .ckpt, then one port step, against one JAX step from the same file
    (f64): params within 1e-9 and batch stats within 1e-12.  Without the
    Adam state the same step lands elsewhere (the check is sensitive)."""
    path, ref = jax_ckpt
    (epoch, best, step), got = _port_resume(path, True)
    assert (epoch, best, step) == (5, 0.5, 2)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=0,
                                   atol=1e-12 if 'running' in k else 1e-9,
                                   err_msg=k)
    _, cold = _port_resume(path, False)
    assert max(np.abs(cold[k] - a).max() for k, a in ref.items()
               if 'running' not in k) > 1e-4


@pytest.mark.parametrize('frozen', [(), ('image_encoder',)])
def test_port_checkpoint_runs_in_the_jax_package(tmp_path, frozen):
    """A port-written msgpack .ckpt (after one Adam step, optionally with
    image_encoder frozen: optax's multi_transform layout) loads into the
    JAX package's CoarseNetExecutor state with its optimizer state, whose
    count, mu and nu are the port's; both predict the same points (atol
    1e-5), and the port reads its own file back into torch Adam."""
    batch = _batch()
    torch.manual_seed(0)
    model = CoarseNet(**TINY)
    ex = CoarseNetExecutor(default_config(**CFG), model, device='cpu')
    ex.init_optimizer(frozen_prefixes=frozen)
    ex.train(batch)
    path = str(tmp_path / 'p.ckpt')
    ckpt.save_checkpoint(2, model, 0.25, path, optimizer=ex.optimizer,
                         step=ex.step, fmt='flax')
    jex = JCoarseNetExecutor(j_default_config(**CFG), JCoarseNet(**TINY))
    jex.init_state(batch, frozen_prefixes=frozen)
    epoch, jex.state, best = j_ckpt.load_checkpoint(path, jex.state)
    assert (epoch, best, int(jex.state.step)) == (3, 0.25, 1)
    opt = flax.serialization.to_state_dict(jex.state.opt_state)
    adam = (opt['inner_states']['train']['inner_state'] if frozen
            else opt)['1']
    assert int(adam['count']) == 1
    mu = flax_to_state_dict({'params': jax.tree.map(np.asarray, adam['mu'])})
    params = dict(model.named_parameters())
    assert set(mu) == {k for k in params if k.split('.')[0] not in frozen}
    for k, m in mu.items():
        np.testing.assert_array_equal(
            m, ex.optimizer.state[params[k]]['exp_avg'].numpy())
    one = (batch['rgb_image'][:1], batch['pc'][:1])
    np.testing.assert_allclose(ex.test(one)[0], jex.test(one)[0], atol=1e-5)

    again = CoarseNetExecutor(default_config(**CFG), CoarseNet(**TINY),
                              device='cpu')
    again.init_optimizer(frozen_prefixes=frozen)
    ckpt.load_checkpoint(path, again.model, optimizer=again.optimizer)
    q = dict(again.model.named_parameters())
    for k, p in params.items():
        if k in mu:
            s, r = again.optimizer.state[q[k]], ex.optimizer.state[p]
            assert float(s['step']) == float(r['step']) == 1
            for key in ('exp_avg', 'exp_avg_sq'):
                assert torch.equal(s[key], r[key])


def test_torch_format_keeps_adam_state_and_refuses_a_mismatch(tmp_path):
    """The torch format round-trips Adam's state by parameter name; an
    optimizer training other parameters than the file's moments is
    refused, as the JAX package refuses it."""
    model = CoarseNet(**TINY)
    ex = CoarseNetExecutor(default_config(**CFG), model, device='cpu')
    ex.init_optimizer(frozen_prefixes=('image_encoder',))
    ex.train(_batch())
    path = str(tmp_path / 't.ckpt')
    ckpt.save_checkpoint(0, model, 1.0, path, optimizer=ex.optimizer, step=1)
    again = CoarseNetExecutor(default_config(**CFG), CoarseNet(**TINY),
                              device='cpu')
    again.init_optimizer(frozen_prefixes=('image_encoder',))
    assert ckpt.load_checkpoint(path, again.model, with_step=True,
                                optimizer=again.optimizer) == (1, 1.0, 1)
    for (k, p), q in zip(model.named_parameters(), again.model.parameters()):
        assert torch.equal(p, q)
        if p in ex.optimizer.state:
            assert torch.equal(ex.optimizer.state[p]['exp_avg_sq'],
                               again.optimizer.state[q]['exp_avg_sq'])
    again.init_optimizer()
    with pytest.raises(ValueError, match='optimizer state'):
        ckpt.load_checkpoint(path, again.model, optimizer=again.optimizer)


# ---- submodules, split_coarse, --resnet_ckpt --------------------------------

@pytest.fixture(scope='module')
def coarse_split(tmp_path_factory):
    """A seeded port CoarseNet, its weights saved by the JAX package (with
    Adam state) and the JAX package's split of that file."""
    root = tmp_path_factory.mktemp('split')
    torch.manual_seed(1)
    coarse = CoarseNet(**TINY)
    variables = state_dict_to_flax(coarse.state_dict())
    jax_path = str(root / 'jax.ckpt')
    j_ckpt.save_checkpoint(6, _jax_state(variables, jnp.float32), 0.1,
                           jax_path)
    (root / 'ref').mkdir()
    j_split(jax_path, str(root / 'ref'))
    return coarse, variables, jax_path, root / 'ref'


@pytest.mark.parametrize('source', ['jax', 'flax', 'torch'])
def test_split_coarse_from_every_format(tmp_path, coarse_split, source):
    """split_coarse of a CoarseNet checkpoint written by the JAX package,
    by the port in the JAX format, or by the port in its torch format,
    writes the JAX package's split of the same weights byte for byte; the
    port's load_submodule puts them into a LIST's im_encoder, im_encoder2
    and point_decoder, and save_submodule writes the JAX package's bytes."""
    coarse, variables, src, ref_dir = coarse_split
    if source != 'jax':
        src = str(tmp_path / f'{source}.ckpt')
        ckpt.save_checkpoint(6, coarse, 0.1, src, fmt=source)
    out = tmp_path / 'out'
    out.mkdir()
    split_coarse_checkpoint(src, str(out))
    for f in ('best_IME_test.ckpt', 'best_PD_test.ckpt'):
        assert (out / f).read_bytes() == (ref_dir / f).read_bytes(), f
    model = LIST(**dict(LIST_TINY, support=10))  # CoarseNet's support
    for name, f in (('im_encoder', 'best_IME_test.ckpt'),
                    ('im_encoder2', 'best_IME_test.ckpt'),
                    ('point_decoder', 'best_PD_test.ckpt')):
        ckpt.load_submodule(str(out / f), model, name)
        src_mod = getattr(coarse, 'point_decoder' if name == 'point_decoder'
                          else 'image_encoder')
        for a, b in zip(getattr(model, name).state_dict().values(),
                        src_mod.state_dict().values()):
            assert torch.equal(a, b)
    if source == 'jax':
        ckpt.save_submodule(7, coarse, 'point_decoder', str(tmp_path / 'pd'))
        j_ckpt.save_submodule(7, _jax_state(variables, jnp.float32),
                              'point_decoder', str(tmp_path / 'jpd'))
        assert (tmp_path / 'pd').read_bytes() == \
            (tmp_path / 'jpd').read_bytes()


def _fake_resnet18(rng):
    """A torchvision resnet18 state dict's keys and shapes, seeded values."""
    sd = {'conv1.weight': (64, 3, 7, 7)}

    def bn(p, c):
        sd.update({f'{p}.weight': (c,), f'{p}.bias': (c,),
                   f'{p}.running_mean': (c,), f'{p}.running_var': (c,),
                   f'{p}.num_batches_tracked': ()})

    bn('bn1', 64)
    cin = 64
    for li, c in ((1, 64), (2, 128), (3, 256), (4, 512)):
        for bi in range(2):
            p = f'layer{li}.{bi}'
            sd[f'{p}.conv1.weight'] = (c, cin if bi == 0 else c, 3, 3)
            sd[f'{p}.conv2.weight'] = (c, c, 3, 3)
            bn(f'{p}.bn1', c)
            bn(f'{p}.bn2', c)
            if bi == 0 and li > 1:
                sd[f'{p}.downsample.0.weight'] = (c, cin, 1, 1)
                bn(f'{p}.downsample.1', c)
        cin = c
    sd.update({'fc.weight': (1000, 512), 'fc.bias': (1000,)})
    return {k: (torch.tensor(7) if s == () else
                torch.from_numpy(rng.rand(*s).astype(np.float32) + 0.5))
            for k, s in sd.items()}


def test_resnet_ckpt_maps_as_the_jax_package(tmp_path):
    """--resnet_ckpt: a torchvision ResNet18 state dict file maps onto
    CoarseNet's image_encoder and LIST's im_encoder / im_encoder2 exactly
    as list_tpu/utils/torch_port.py maps it (conv1 and fc1 untouched)."""
    path = str(tmp_path / 'resnet18.pth')
    torch.save(_fake_resnet18(np.random.RandomState(0)), path)
    torch.manual_seed(2)
    coarse = CoarseNet(**TINY)
    variables = state_dict_to_flax(coarse.state_dict())
    before = {k: v.clone() for k, v in coarse.state_dict().items()}
    assert apply_resnet_ckpt(coarse, path) == ['image_encoder']
    j_state, hit = j_apply_resnet(_jax_state(variables, jnp.float32), path)
    assert hit == ['image_encoder']
    ref = flax_to_state_dict(jax.tree.map(np.asarray, {
        'params': j_state.params, 'batch_stats': j_state.batch_stats}))
    for k, v in coarse.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ('image_encoder.conv1.weight', 'image_encoder.fc1.weight'):
        assert torch.equal(coarse.state_dict()[k], before[k])
    assert not torch.equal(coarse.state_dict()['image_encoder.fc.weight'],
                           before['image_encoder.fc.weight'])
    model = LIST(**LIST_TINY)
    assert apply_resnet_ckpt(model, path) == ['im_encoder', 'im_encoder2']
    for name in ('im_encoder', 'im_encoder2'):
        for k, v in getattr(model, name).state_dict().items():
            if not k.startswith(('conv1.', 'fc1.')):
                assert torch.equal(
                    v, coarse.image_encoder.state_dict()[k]), (name, k)


# ---- the driver, end to end -------------------------------------------------

def _argv(d):
    out = []
    for k, v in d.items():
        if v is True:
            out.append(f'--{k}')
        elif isinstance(v, (list, tuple)):
            out += [f'--{k}'] + [str(x) for x in v]
        else:
            out += [f'--{k}', str(v)]
    return out


@pytest.fixture(scope='module')
def e2e(tmp_path_factory):
    """The port's tree and flags: tests/test_e2e.py's tiny sizes."""
    from list_tpu_torch.data import generate_synthetic_shapenet
    root = str(tmp_path_factory.mktemp('e2e'))
    data = os.path.join(root, 'shapenet')
    generate_synthetic_shapenet(data, cats=('03001627',), n_shapes=2,
                                n_views=2, img_res=32, n_surface=1200)
    flags = dict(
        image_dir=os.path.join(data, 'images') + '/',
        h5_dir=os.path.join(data, 'sampled_points') + '/',
        mesh_dir=os.path.join(data, 'mesh') + '/',
        split_dir=os.path.join(data, 'split'),
        testlist_file=os.path.join(data, 'split', 'testlist_all.lst'),
        output_dir=os.path.join(root, 'results') + '/',
        catlist=['03001627'], viewnum=2, img_res=32, vox_res=16,
        sample_point_density=128, coarse_point_density=1000,
        train_batch_size=2, epochs=1, save_every_epoch=1,
        test_every_epoch=1, point_feat=[128, 8, 8, 3],
        point_degree=[2, 2, 4], im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4],
        sdf_scale=10.0, test_pointnum=1024, lr=1e-3, num_workers=2,
        chunk_l=2, test_cam_id=0)
    return root, flags


def test_two_stage_recipe_then_sweep(e2e):
    """train_torch.py (CoarseNet, testlist eval with --eval_pred) ->
    a resumed second epoch (Adam state and epoch restored, two steps per
    dispatch, a profiler trace) -> split_coarse's CLI -> the warm-started
    LIST (im_encoder and point_decoder bit-identical to the split after the
    epoch, im_encoder2 moved) -> infer_torch.py's sweeps of both models
    (CoarseNet's through the serial per-shape path), each writing a CSV
    with a Mean row; all with --device cpu."""
    import infer_torch
    import train_torch
    from list_tpu_torch.train import split_coarse
    root, flags = e2e
    stage1 = dict(flags, exp_name='coarse_prediciton',
                  model='network.models.CoarseNet',
                  dataset='datasets.Datasets.IM2PointFarthest',
                  eval_pred=True)
    train_torch.main(_argv(stage1) + ['--device', 'cpu'])
    c1 = default_config(**stage1)
    have = set(os.listdir(c1.checkpoint_dir))
    assert {'model_1.ckpt', 'best_model_train.ckpt',
            'best_model_test.ckpt'} <= have
    assert os.path.exists(os.path.join(c1.results_dir, 'code',
                                       'list_tpu_torch', 'train',
                                       'trainer.py'))
    prof = os.path.join(root, 'prof')
    train_torch.main(_argv(dict(stage1, epochs=2, train_batch_size=1,
                                save_every_epoch=2, steps_per_dispatch=2,
                                profile_dir=prof)) + ['--device', 'cpu'])
    epoch, _, step = ckpt.load_checkpoint(
        os.path.join(c1.checkpoint_dir, 'model_2.ckpt'), None,
        with_step=True)
    assert (epoch, step) == (2, 3)
    assert os.path.getsize(os.path.join(prof, 'trace.json')) > 0

    split_coarse.main(['--exp_name', 'coarse_prediciton', '--output_dir',
                       flags['output_dir']])
    stage2 = dict(flags, exp_name='list_stage2', model='network.models.LIST',
                  dataset='datasets.Datasets.IM2SDF', warm_start=True,
                  eval_pred=True, sample_distribution=[0.45, 0.44, 0.1])
    train_torch.main(_argv(dict(stage2, save_every_epoch=100))
                     + ['--device', 'cpu'])
    c2 = default_config(**stage2)
    trained, split = LIST.from_config(c2), LIST.from_config(c2)
    assert ckpt.load_checkpoint(os.path.join(
        c2.checkpoint_dir, 'best_model_train.ckpt'), trained)[0] == 1
    for name, f in (('im_encoder', 'best_IME_test.ckpt'),
                    ('im_encoder2', 'best_IME_test.ckpt'),
                    ('point_decoder', 'best_PD_test.ckpt')):
        ckpt.load_submodule(os.path.join(c1.checkpoint_dir, f), split, name)
    same = {n: all(torch.equal(a, b) for a, b in zip(
        getattr(trained, n).parameters(), getattr(split, n).parameters()))
        for n in ('im_encoder', 'point_decoder', 'im_encoder2')}
    assert same == {'im_encoder': True, 'point_decoder': True,
                    'im_encoder2': False}

    sweep = dict(stage2, test_checkpoint='best_model_train.ckpt')
    del sweep['warm_start']
    for flags_, cfg in ((sweep, c2), (stage1, c1)):  # CoarseNet: serial
        infer_torch.main(_argv(flags_) + ['--device', 'cpu'])
        csvs = [os.path.join(d, f) for d, _, fs in os.walk(cfg.results_dir)
                for f in fs if f.endswith('.csv')]
        assert csvs and all('Mean' in open(p).read() for p in csvs)


def test_train_refuses_cpu_fallback(e2e):
    """No device -> cuda; on a host without CUDA train() raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is honoured')
    from list_tpu_torch.train.trainer import train
    _, flags = e2e
    cfg = default_config(**dict(flags, exp_name='nocard',
                                model='network.models.CoarseNet',
                                dataset='datasets.Datasets.IM2PointFarthest'))
    with pytest.raises(RuntimeError, match='cuda'):
        train(cfg)


class _StubExecutor:
    """Records how the trainer steps it: single ``train`` calls or
    ``train_multi`` groups."""

    def __init__(self):
        self.calls = []

    def train(self, batch, calc_loss=True):
        self.calls.append('train')
        return None, {'loss': torch.tensor(float(batch))}

    def train_multi(self, batches):
        self.calls.append(f'train_multi {len(batches)}')
        return None, {'loss': torch.tensor([float(b) for b in batches])}


@pytest.mark.parametrize('checkify', [False, True])
def test_step_losses_takes_single_steps_under_checkify(checkify):
    """--steps_per_dispatch 2 groups steps through train_multi (a ragged
    tail of single steps), except under --checkify, where every step is a
    single, checked train() call, as in the JAX package; the losses come
    back in order either way."""
    from list_tpu_torch.train.trainer import _step_losses
    cfg = default_config(steps_per_dispatch=2, checkify=checkify)
    ex = _StubExecutor()
    losses = [d['loss'] for d in _step_losses(ex, cfg, [1, 2, 3, 4, 5])]
    assert losses == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert ex.calls == (['train'] * 5 if checkify else
                        ['train_multi 2', 'train_multi 2', 'train'])
