"""Multi-process data parallelism of the port on the CPU: the runtime entry
(``parallel/multihost.py``), global-batch BatchNorm, the data-parallel
LIST and CoarseNet steps, ``train()`` and ``test_all()`` over two ranks,
the split dense decode and the offline evaluation scripts, against the
JAX package and the 1-process port.

Two ranks run as subprocesses joined by gloo on 127.0.0.1 (one thread
each, from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).  They run
this file as a script: every job of ``JOBS`` in order, each writing its
results under the job directory.  Beside them a third process, without
torch, computes the JAX package's multi-device references
(``_JAX_REFERENCE``); the test process computes the rest."""

import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from list_tpu_torch.config import default_config
from list_tpu_torch.models import LIST, CoarseNet
from list_tpu_torch.models.norm import BatchNorm, checkpoint
from list_tpu_torch.parallel import mesh, multihost
from list_tpu_torch.train import LISTExecutor
from list_tpu_torch.train.executors import CoarseNetExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 1e-3
TINY = dict(vox_res=16, point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4),
            im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)
COARSE_TINY = dict(point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4))
# test_torch_train.py's tiny step at a global batch of 4
STEP_CFG = dict(vox_res=16, img_res=32, sample_point_density=128,
                coarse_point_density=500, train_batch_size=4,
                point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
                im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
                test_pointnum=1024, lr=LR, remat=1, train_query_chunks=2)
BN_SHAPES = {'1d': (4, 5), '2d': (4, 3, 4, 4), '3d': (4, 2, 3, 3, 3)}
RANK_TIMEOUT_S = 300
TRAIN_SEED = 11


# ---- the ranks' side ----------------------------------------------------------

def _load(path):
    return torch.load(path, weights_only=False)  # written by the test


def _step_record(ex, losses):
    opt = ex.optimizer
    names = {id(p): k for k, p in ex.model.named_parameters()}
    return dict(
        losses={k: float(v) for k, v in losses.items()},
        grads={k: p.grad.clone() for k, p in ex.model.named_parameters()
               if p.grad is not None},
        state={k: v.clone() for k, v in ex.model.state_dict().items()},
        adam={names[id(p)]: (s['exp_avg'].clone(), s['exp_avg_sq'].clone())
              for p, s in opt.state.items()})


def _bn_runs(cases, rows=slice(None)):
    """Per case and remat flag: two training updates of ``BatchNorm`` on
    the rows ``rows`` of each global input, upstream gradient ``r``."""
    out = {}
    for name, c in cases.items():
        for remat in (False, True):
            bn = BatchNorm(c['x'][0].shape[1]).to(c['x'][0].dtype)
            with torch.no_grad():
                bn.weight.copy_(c['w'])
                bn.bias.copy_(c['b'])
            bn.train()
            steps = []
            for x, r in zip(c['x'], c['r']):
                xr = x[rows].clone().requires_grad_()
                y = checkpoint(bn, xr) if remat else bn(xr)
                (y * r[rows]).sum().backward()
                steps.append(dict(y=y.detach(), gx=xr.grad,
                                  gw=bn.weight.grad.clone(),
                                  gb=bn.bias.grad.clone(),
                                  mean=bn.running_mean.clone(),
                                  var=bn.running_var.clone()))
                bn.weight.grad = bn.bias.grad = None
            out[(name, remat)] = steps
    return out


def _job_init(spec, rank):
    return dict(rank=rank, info=multihost.process_info(),
                device=str(multihost.rank_device()),
                moments_group=multihost.moments_group() is not None,
                rows=mesh.rank_rows(4))


def _job_bn(spec, rank):
    return _bn_runs(_load(spec['bn']), mesh.rank_rows(4))


def _job_list_step(spec, rank):
    d = _load(spec['list_step'])
    tm = LIST(**TINY, remat=True, train_query_chunks=2,
              vox_packed_dtype=None).double()
    tm.load_state_dict(d['state'])
    ex = LISTExecutor(default_config(**STEP_CFG), tm, device='cpu')
    _, losses = ex.train(d['batch'])
    return _step_record(ex, losses)


def _job_coarse_step(spec, rank):
    d = _load(spec['coarse_step'])
    tm = CoarseNet(**COARSE_TINY).double()
    tm.load_state_dict(d['state'])
    ex = CoarseNetExecutor(default_config(**d['cfg']), tm, device='cpu')
    _, losses = ex.train(d['batch'])
    return _step_record(ex, losses)


def _job_train(spec, rank):
    from list_tpu_torch.train.trainer import train
    flags = dict(spec['train'], output_dir=spec['train']['output_dir']
                 + f'r{rank}/', multihost=1)
    torch.manual_seed(TRAIN_SEED)  # the model's init (rank 0's is kept)
    train(default_config(**flags), device='cpu')


def _job_sweep(spec, rank):
    from list_tpu_torch.infer.pipeline import test_all
    np.random.seed(0)
    return test_all(default_config(**dict(spec['sweep'], multihost=1)),
                    device='cpu')


JOBS = ('init', 'bn', 'list_step', 'coarse_step', 'train', 'sweep')


def _rank_main(spec_path):
    torch.set_num_threads(1)
    with open(spec_path, 'rb') as f:
        spec = pickle.load(f)
    rank = multihost.initialize(device='cpu')
    try:
        for job in JOBS:
            out = os.path.join(spec['dir'], f'{job}_r{rank}')
            try:
                res = globals()[f'_job_{job}'](spec, rank)
            except Exception:
                with open(out + '.err', 'w') as f:
                    f.write(traceback.format_exc())
                raise
            torch.save(res, out + '.pt')
        multihost.sync_global_devices('done')
    finally:
        multihost.shutdown()


# ---- the JAX package's multi-device references ------------------------------
# A process of their own computes them, with XLA's CPU backend at
# optimization level 2: at the default level the f64 step over 4 devices
# crashes XLA's CPU compiler (SIGSEGV) in about a third of the runs
# (jaxlib 0.9.0), with or without torch in the process; in f32, on one
# device, or at levels 0-2 it ran clean every time.  The level only moves
# the f32 occupancy loss's summation order, within its rtol 1e-5 below at
# level 2 (not at level 0, whose sequential sum falls outside it).

_JAX_REFERENCE = r"""
import os, pickle, sys
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax, jax.numpy as jnp, numpy as np
jax.config.update('jax_platforms', 'cpu')
assert 'torch' not in sys.modules
from list_tpu.config import default_config
from list_tpu.models import LIST
from list_tpu.parallel import auto_mesh, batch_sharding, make_mesh, replicated
from list_tpu.train import LISTExecutor, total_loss
from list_tpu.train.state import TrainState, make_optimizer

with open(sys.argv[1], 'rb') as f:
    d = pickle.load(f)
np_ = lambda t: jax.tree.map(np.asarray, t)
out = {}

# list_tpu's step at the global batch on its data mesh (auto_mesh: the
# batch sharded, the state replicated), f64, features in the compute dtype
jex = LISTExecutor(default_config(**d['step_cfg']),
                   LIST(**d['tiny'], train_query_chunks=2))
jm = LIST(**d['tiny'], train_query_chunks=2, vox_packed_dtype=None)
m = auto_mesh(4)
assert m.devices.size == 4
keep = jex._train_keys(d['batch'])
with jax.enable_x64(True):
    cast = lambda t: jax.device_put(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64), t), replicated(m))
    params = cast(d['variables']['params'])
    stats = cast(d['variables']['batch_stats'])
    img, pts, vals = (jax.device_put(np.asarray(keep[k], np.float64),
                                     batch_sharding(m))
                      for k in ('rgb_image', 'points', 'values'))
    occ = jax.device_put(np.asarray(keep['occ'], np.float32),
                         batch_sharding(m))

    def loss_fn(p):
        (occ_pred, sdf_pred), upd = jm.apply(
            {'params': p, 'batch_stats': stats}, img, pts, None, True,
            mutable=['batch_stats'])
        losses = jex.calc_loss((occ_pred, sdf_pred), (occ, vals))
        return total_loss(losses), (losses, upd['batch_stats'])

    (_, (losses, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = TrainState.create(params, stats,
                              make_optimizer(d['lr'], weight_decay=1e-5))
    state = jax.jit(lambda s, g, n: s.apply_gradients(
        g, new_batch_stats=n))(state, grads, new_stats)
    out['step'] = ({k: float(v) for k, v in losses.items()}, np_(grads),
                   np_(state.params), np_(state.batch_stats))

# predict_grid on a 2-device mesh (its shard_map over the slabs), fc_out's
# bias shifted so that the grid has its median at zero
pex = LISTExecutor(default_config(**d['predict_cfg']), LIST(**d['tiny']),
                   mesh=make_mesh((2,)))
pex.init_state({'rgb_image': d['image']})
grid = dict(fetch_dtype='float32', fetch_mode='grid')
params = np_(pex.state.params)
med = float(np.median(pex.predict_grid(d['image'], **grid)))
fc_out = params['sdf_decoder']['fc_out']
fc_out['bias'] = fc_out['bias'] - med * d['predict_cfg']['sdf_scale']
pex.state = pex.state.replace(params=params)
out['predict'] = ({'params': params, 'batch_stats': np_(
    pex.state.batch_stats)}, pex.predict_grid(d['image'], **grid))
with open(sys.argv[2], 'wb') as f:
    pickle.dump(out, f)
"""

PREDICT_CFG = dict(vox_res=16, img_res=32, point_feat=[128, 8, 8, 3],
                   point_degree=[2, 2, 4],
                   im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
                   test_pointnum=1024, mesh_shape=[2])
PREDICT_IMAGE = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)


# ---- the test process's side --------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Ranks:
    """Two rank processes and the JAX reference's process, started at once;
    ``result`` waits for the ranks (at most RANK_TIMEOUT_S), then reads one
    job's result of one rank; ``jax_reference`` waits for the other."""

    def __init__(self, spec, spec_path):
        self.spec = spec
        self.jax_out = os.path.join(spec['dir'], 'jax_reference.pkl')
        xla = os.environ.get('XLA_FLAGS', '')
        self.jax_proc = subprocess.Popen(
            [sys.executable, '-c', _JAX_REFERENCE, spec['jax_in'],
             self.jax_out], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, XLA_FLAGS=(
                xla + ' --xla_backend_optimization_level=2').strip()),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        port = _free_port()
        self.procs = []
        for rank in range(WORLD):
            env = dict(os.environ, COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                       NUM_PROCESSES=str(WORLD), PROCESS_ID=str(rank),
                       PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                       LIST_TPU_EVAL_WORKERS='1', LIST_TPU_NATIVE_THREADS='1')
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), spec_path],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        self.outs = None

    def wait(self):
        if self.outs is None:
            deadline = time.time() + RANK_TIMEOUT_S
            self.outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(deadline - time.time(), 1))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    out = p.communicate()[0] + '\n(killed at the timeout)'
                self.outs.append(out)
        return self.outs

    def result(self, job, rank=0):
        outs = self.wait()
        base = os.path.join(self.spec['dir'], f'{job}_r{rank}')
        if not os.path.exists(base + '.pt'):
            err = base + '.err'
            raise AssertionError(
                f'rank {rank}, job {job}: no result\n'
                + (open(err).read() if os.path.exists(err) else '')
                + f'\nrank output:\n{outs[rank][-3000:]}')
        return _load(base + '.pt')

    def jax_reference(self):
        try:
            out, _ = self.jax_proc.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.jax_proc.kill()
            out = self.jax_proc.communicate()[0] + '\n(killed at the timeout)'
        assert self.jax_proc.returncode == 0, out[-3000:]
        with open(self.jax_out, 'rb') as f:
            return pickle.load(f)

    def close(self):
        for p in self.procs + [self.jax_proc]:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _bn_cases(dtype, seed=0):
    rng = np.random.RandomState(seed)
    cases = {}
    for name, shape in BN_SHAPES.items():
        t = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
        cases[name] = dict(
            x=[t(rng.randn(*shape) * 2 + 0.5) for _ in range(2)],
            r=[t(rng.randn(*shape)) for _ in range(2)],
            w=t(rng.rand(shape[1]) + 0.5), b=t(rng.randn(shape[1])))
    return cases


def _f64_state(model):
    return {k: v.double() for k, v in model.state_dict().items()}


def _tree_flags(data, root):
    return dict(
        image_dir=os.path.join(data, 'images') + '/',
        h5_dir=os.path.join(data, 'sampled_points') + '/',
        mesh_dir=os.path.join(data, 'mesh') + '/',
        split_dir=os.path.join(data, 'split'),
        testlist_file=os.path.join(data, 'split', 'testlist_all.lst'),
        catlist=['03001627'], viewnum=2, img_res=32, vox_res=16,
        sample_point_density=128, coarse_point_density=1000,
        point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
        im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
        test_pointnum=1024, lr=LR, num_workers=1, test_cam_id=0,
        eval_pred=True)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The ranks' inputs, written before they start: BatchNorm cases, the
    tiny LIST's seeded variables (test_torch_train.py's fill) and a global
    batch of 4, a seeded CoarseNet and its batch of 4, a 2-shape synthetic
    ShapeNet tree with train() and test_all() flags and a checkpoint of the
    tiny LIST whose first test grid has its median at zero."""
    from list_tpu.models import LIST as JLIST
    from list_tpu_torch.data import (SyntheticSDFDataset, collate,
                                     generate_synthetic_shapenet)
    from list_tpu_torch.train.checkpoints import save_checkpoint
    from test_torch_train import _seeded_variables
    root = str(tmp_path_factory.mktemp('parallel'))
    jobs = os.path.join(root, 'jobs')
    os.makedirs(jobs)
    spec = dict(dir=jobs)

    spec['bn'] = os.path.join(root, 'bn.pt')
    torch.save({**{f'{k} f64': v for k, v in
                   _bn_cases(torch.float64).items()},
                **{f'{k} f32': v for k, v in
                   _bn_cases(torch.float32).items()}}, spec['bn'])

    cfg = default_config(**STEP_CFG)
    ds = SyntheticSDFDataset(cfg, 'train', n_shapes=4)
    batch = collate([ds[i] for i in range(4)])
    jm = JLIST(**TINY, train_query_chunks=2, vox_packed_dtype=None)
    variables = _seeded_variables(jm, batch['rgb_image'].shape)
    tm = LIST(**TINY, remat=True, train_query_chunks=2,
              vox_packed_dtype=None)
    load_flax_variables(tm, variables)
    spec['list_step'] = os.path.join(root, 'list_step.pt')
    torch.save(dict(state=_f64_state(tm), batch=batch),
               spec['list_step'])

    rng = np.random.RandomState(3)
    coarse_cfg = dict(img_res=32, train_batch_size=4, lr=LR,
                      point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4])
    torch.manual_seed(5)
    spec['coarse_step'] = os.path.join(root, 'coarse_step.pt')
    torch.save(dict(
        state=_f64_state(CoarseNet(**COARSE_TINY)), cfg=coarse_cfg,
        batch={'rgb_image': rng.rand(4, 32, 32, 3).astype(np.float32),
               'pc': (rng.rand(4, 300, 3) - 0.5).astype(np.float32)}),
        spec['coarse_step'])

    data = os.path.join(root, 'shapenet')
    generate_synthetic_shapenet(data, cats=('03001627',), n_shapes=2,
                                n_views=2, img_res=32, n_surface=1200)
    flags = _tree_flags(data, root)
    spec['train'] = dict(flags, model='network.models.CoarseNet',
                         dataset='datasets.Datasets.IM2PointFarthest',
                         exp_name='coarse', train_batch_size=2, epochs=1,
                         save_every_epoch=2, test_every_epoch=1,
                         output_dir=os.path.join(root, 'train') + '/')
    sweep = dict(flags, model='network.models.LIST',
                 dataset='datasets.Datasets.IM2SDF', exp_name='sweep')
    scfg = default_config(**sweep)
    torch.manual_seed(7)
    model = LIST.from_config(scfg)
    from list_tpu_torch.data.shapenet import IM2SDF
    img = IM2SDF(scfg, 'test').get_testdata('03001627', 'synth0000',
                                            0)['rgb_image']
    med = float(np.median(LISTExecutor(scfg, model, device='cpu')
                          .predict_grid(img, fetch_mode='grid')))
    with torch.no_grad():
        model.sdf_decoder.fc_out.bias -= med * scfg.sdf_scale
    for name in ('sweep1', 'sweep2'):
        c = default_config(**dict(sweep, output_dir=os.path.join(
            root, name) + '/'))
        save_checkpoint(0, model, 0.5, os.path.join(c.checkpoint_dir,
                                                    c.test_checkpoint))
    spec['sweep'] = dict(sweep, output_dir=os.path.join(root, 'sweep2') + '/')
    spec['sweep1'] = dict(sweep, output_dir=os.path.join(root, 'sweep1') + '/')
    spec['jax_in'] = os.path.join(root, 'jax_in.pkl')
    with open(spec['jax_in'], 'wb') as f:
        pickle.dump(dict(variables=variables, batch=batch, tiny=TINY,
                         step_cfg=STEP_CFG, lr=LR, predict_cfg=PREDICT_CFG,
                         image=PREDICT_IMAGE), f)
    spec['root'] = root
    return spec


@pytest.fixture(scope='module')
def ranks(setup):
    path = os.path.join(setup['root'], 'spec.pkl')
    with open(path, 'wb') as f:
        pickle.dump(setup, f)
    r = _Ranks(setup, path)
    yield r
    r.close()


# ---- the runtime entry --------------------------------------------------------

def test_shard_datalist_is_the_jax_packages():
    """The strided per-process slice equals list_tpu's for every rank of
    1-4 processes."""
    from list_tpu.parallel.multihost import shard_datalist as j_shard
    data = [f'shape_{i}' for i in range(11)]
    for n in (1, 2, 3, 4):
        for i in range(n):
            assert multihost.shard_datalist(data, i, n) == \
                j_shard(data, i, n)
    assert multihost.shard_datalist(data) == data  # no group: everything


def test_initialize_single_process_noop():
    """An explicit single process (num_processes 1, no coordinator) joins
    nothing, returns 0 and is idempotent; the per-rank rows are then the
    whole batch, and a batch the world does not divide raises."""
    assert multihost.initialize(num_processes=1) == 0
    assert multihost.initialize(num_processes=1) == 0
    assert multihost.process_info() == (0, 1)
    assert multihost.rank_device() is None
    assert mesh.rank_rows(4) == slice(0, 4)
    assert mesh.rank_rows(4, 1, 2) == slice(2, 4)
    with pytest.raises(ValueError, match='divide'):
        mesh.rank_rows(3, 0, 2)


def test_initialize_from_the_environment(ranks):
    """Two processes started with COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID join one gloo group of 2 on the CPU, with the moments'
    group, and rank r takes rows [2r, 2r + 2) of a batch of 4."""
    for rank in range(WORLD):
        got = ranks.result('init', rank)
        assert got['info'] == (rank, WORLD)
        assert got['device'] == 'cpu' and got['moments_group']
        assert got['rows'] == slice(2 * rank, 2 * rank + 2)


def test_a_cuda_rank_without_a_card_raises():
    """initialize() without a device asks for the rank's card, and raises
    where there is none: no rank falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        multihost.initialize('127.0.0.1:1', 2, 0)
    assert multihost.process_info() == (0, 1)


# ---- global-batch BatchNorm ---------------------------------------------------

@pytest.mark.parametrize('name', sorted(BN_SHAPES))
def test_batchnorm_two_ranks_is_the_global_batch(ranks, setup, name):
    """2 ranks x batch 2 against one process x batch 4, two training
    updates in f64: outputs and input gradients (each rank's rows), the
    weight and bias gradients (summed over the ranks) and the running
    statistics (on each rank) agree to 1e-12; under ``checkpoint`` (the
    backward recomputes the forward and its all-reduces) every number is
    the plain run's, bit for bit, and the statistics update once."""
    one = _bn_runs({name: _load(setup['bn'])[f'{name} f64']})
    got = [ranks.result('bn', r) for r in range(WORLD)]
    for remat in (False, True):
        ref = one[(name, False)]
        runs = [g[(f'{name} f64', remat)] for g in got]
        for i, want in enumerate(ref):
            steps = [run[i] for run in runs]
            for k in ('y', 'gx'):
                torch.testing.assert_close(
                    torch.cat([s[k] for s in steps]), want[k], atol=1e-12,
                    rtol=0)
            for k in ('gw', 'gb'):
                torch.testing.assert_close(sum(s[k] for s in steps),
                                           want[k], atol=1e-12, rtol=0)
            for s in steps:
                for k in ('mean', 'var'):
                    torch.testing.assert_close(s[k], want[k], atol=1e-12,
                                               rtol=0)
    for a, b in zip(got[0][(f'{name} f64', True)],
                    got[0][(f'{name} f64', False)]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('name', sorted(BN_SHAPES))
def test_batchnorm_two_ranks_matches_flax(ranks, setup, name):
    """The 2-rank f32 run against flax's BatchNorm(momentum=0.9) at batch
    4: outputs and running statistics of two updates, atol 1e-5 (f32), the
    tolerance of test_torch_train.py's test_batchnorm_matches_flax."""
    c = _load(setup['bn'])[f'{name} f32']
    to_cl = lambda a: np.moveaxis(np.asarray(a), 1, -1)  # noqa: E731
    jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(to_cl(c['x'][0])),
                use_running_average=False)
    v = {'params': {'scale': jnp.asarray(c['w'].numpy()),
                    'bias': jnp.asarray(c['b'].numpy())},
         'batch_stats': v['batch_stats']}
    runs = [ranks.result('bn', r)[(f'{name} f32', False)]
            for r in range(WORLD)]
    for i, x in enumerate(c['x']):
        ref, upd = jm.apply(v, jnp.asarray(to_cl(x)),
                            use_running_average=False,
                            mutable=['batch_stats'])
        v = {'params': v['params'], 'batch_stats': upd['batch_stats']}
        y = torch.cat([run[i]['y'] for run in runs])
        np.testing.assert_allclose(to_cl(y), np.asarray(ref), atol=1e-5)
        for run in runs:
            np.testing.assert_allclose(
                run[i]['mean'].numpy(), np.asarray(v['batch_stats']['mean']),
                atol=1e-5)
            np.testing.assert_allclose(
                run[i]['var'].numpy(), np.asarray(v['batch_stats']['var']),
                atol=1e-5)


# ---- the data-parallel train steps --------------------------------------------

def _assert_ranks_identical(r0, r1):
    """Parameters, buffers (BatchNorm statistics) and Adam moments bit for
    bit."""
    for part in ('state', 'adam'):
        assert r0[part].keys() == r1[part].keys()
        for k, a in r0[part].items():
            b = r1[part][k]
            pairs = zip(a, b) if part == 'adam' else ((a, b),)
            for x, y in pairs:
                assert torch.equal(x, y), (part, k)


def _state_errors(j_sd, t_sd, lr_bound):
    """Worst differences of the updated params and batch stats (as
    test_torch_train.py's)."""
    out = {'params': [], 'stats': [], 'moved': []}
    for k, a in j_sd.items():
        d = np.abs(np.asarray(t_sd[k]) - np.asarray(a))
        out['stats' if 'running' in k else 'params'].append((d.max(), k))
        if 'running' not in k:
            out['moved'].append(((d > lr_bound).mean(), k))
    return {k: max(v) for k, v in out.items()}


@pytest.fixture(scope='module')
def jax_mesh_step(ranks):
    """list_tpu's step at batch 4 on its data mesh (``auto_mesh(4)`` over
    conftest's 8 virtual CPU devices: the batch sharded, the state
    replicated), in f64 with the features in the compute dtype, as
    test_torch_train.py's ``step64``: losses, gradients, and the params and
    batch stats after one Adam step (``_JAX_REFERENCE``)."""
    losses, grads, params, stats = ranks.jax_reference()['step']
    return (losses, flax_to_state_dict({'params': grads}),
            flax_to_state_dict({'params': params, 'batch_stats': stats}))


def test_list_step_matches_the_jax_package_on_its_data_mesh(ranks,
                                                             jax_mesh_step):
    """2 ranks x batch 2 (gloo) against list_tpu's batch-4 step on its
    4-device data mesh, f64, at test_torch_train.py's test_step_f64_*
    tolerances: sdf losses rtol 1e-9 and occ_loss 1e-5 (both packages
    compute it in f32); every gradient within 1e-10 + 1e-4 * max|jax|;
    params within 2 * lr + 1e-9 with at most 1% of any parameter's
    elements beyond 1e-6 (Adam's first step is lr * sign(g), and a
    gradient within the f32 occupancy loss's rounding of zero may flip);
    batch stats 1e-9.  Remat runs on the ranks (the global BatchNorm's
    recompute), not in the JAX step."""
    jl, jg, jsd = jax_mesh_step
    got = ranks.result('list_step', 0)
    assert set(got['losses']) == set(jl)
    for k in jl:
        np.testing.assert_allclose(got['losses'][k], jl[k],
                                   rtol=1e-5 if k == 'occ_loss' else 1e-9)
    assert set(got['grads']) == set(jg)
    bad = [(k, float((got['grads'][k].numpy() - a).__abs__().max()))
           for k, a in jg.items()
           if np.abs(got['grads'][k].numpy() - a).max()
           > 1e-10 + 1e-4 * np.abs(a).max()]
    assert not bad, bad
    err = _state_errors(jsd, {k: v.numpy() for k, v in got['state'].items()},
                        1e-6)
    assert err['params'][0] <= 2 * LR + 1e-9, err
    assert err['moved'][0] <= 0.01, err
    assert err['stats'][0] <= 1e-9, err


@pytest.mark.parametrize('job', ['list_step', 'coarse_step'])
def test_ranks_keep_bit_identical_state(ranks, job):
    """After a data-parallel step both ranks hold the same parameters,
    BatchNorm statistics and Adam moments, bit for bit, and report the
    same (all-reduced) losses."""
    r0, r1 = (ranks.result(job, r) for r in range(WORLD))
    _assert_ranks_identical(r0, r1)
    assert r0['losses'] == r1['losses']


def test_coarse_step_two_ranks_is_the_global_batch(ranks, setup):
    """Stage 1: 2 ranks x 2 against one process x 4 (the port's
    CoarseNetExecutor), f64: the Chamfer loss rtol 1e-9, every gradient
    within 1e-10 + 1e-8 * max|g|, batch stats 1e-10, params within
    2 * lr + 1e-12 with at most 1% of any parameter's elements beyond
    1e-9 (conv biases before a BatchNorm have a gradient of zero up to
    rounding, whose sign Adam's first step keeps)."""
    d = _load(setup['coarse_step'])
    tm = CoarseNet(**COARSE_TINY).double()
    tm.load_state_dict(d['state'])
    ex = CoarseNetExecutor(default_config(**d['cfg']), tm, device='cpu')
    _, losses = ex.train(d['batch'])
    one = _step_record(ex, losses)
    got = ranks.result('coarse_step', 0)
    np.testing.assert_allclose(got['losses']['chamfer_loss'],
                               one['losses']['chamfer_loss'], rtol=1e-9)
    assert got['grads'].keys() == one['grads'].keys()
    for k, g in one['grads'].items():
        tol = 1e-10 + 1e-8 * float(g.abs().max())
        assert float((got['grads'][k] - g).abs().max()) <= tol, k
    err = _state_errors({k: v.numpy() for k, v in one['state'].items()},
                        {k: v.numpy() for k, v in got['state'].items()},
                        1e-9)
    assert err['params'][0] <= 2 * LR + 1e-12, err
    assert err['moved'][0] <= 0.01, err
    assert err['stats'][0] <= 1e-10, err


# ---- the driver and the sweep over two ranks ------------------------------------

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_train_two_ranks_writes_from_rank_0_only(ranks, setup):
    """train() over 2 ranks (each given its own output directory here;
    torch seeded alike before the model is built): rank 0 writes the checkpoints, the log and the summaries, rank 1 writes
    no file; rank 0's checkpoints agree with a 1-process train() at the
    same global batch (f32, the epoch's one step: params within
    2 * lr + 1e-5, Adam's first step being lr * sign(g) with signs free to
    flip where g is rounding; at most 1% of any parameter's elements beyond
    1e-5; batch stats 1e-3, as test_torch_train.py holds f32 batch-2
    statistics), and both runs pick the same best test model."""
    from list_tpu_torch.train import checkpoints as ckpt
    from list_tpu_torch.train.trainer import train
    ranks.wait()
    root = setup['train']['output_dir']
    assert _files(root + 'r1/') == []
    written = _files(root + 'r0/')
    for f in ('coarse/checkpoints/best_model_train.ckpt', 'coarse/log.txt'):
        assert f in written, written
    assert any(f.startswith('coarse/summary/') for f in written)
    one = default_config(**dict(setup['train'], output_dir=root + 'one/'))
    torch.manual_seed(TRAIN_SEED)
    train(one, device='cpu')
    assert [f for f in _files(root + 'one/') if f.endswith('.ckpt')] == \
        [f for f in written if f.endswith('.ckpt')]
    a, b = CoarseNet.from_config(one), CoarseNet.from_config(one)
    ckpt.load_checkpoint(root + 'r0/coarse/checkpoints/best_model_train.ckpt',
                         a)
    ckpt.load_checkpoint(root + 'one/coarse/checkpoints/best_model_train.ckpt',
                         b)
    err = _state_errors({k: v.numpy() for k, v in b.state_dict().items()},
                        {k: v.numpy() for k, v in a.state_dict().items()},
                        1e-5)
    assert err['params'][0] <= 2 * LR + 1e-5, err
    assert err['moved'][0] <= 0.01, err
    assert err['stats'][0] <= 1e-3, err


def _csv_rows(path):
    import csv
    with open(path) as f:
        header, *rows = list(csv.reader(f))
    return header, rows


def test_sweep_two_ranks_is_the_one_process_sweep(ranks, setup,
                                                  monkeypatch):
    """test_all with --multihost 1 over 2 ranks: rank r sweeps the strided
    shapes r::2 and writes <cat>_p{r}.csv; together their rows are the
    1-process sweep's, metrics within test_torch_sweep.py's rtol 7e-2 /
    atol 2e-2 (the metrics' point sampling draws from each process's
    np.random stream, seeded alike at each sweep's start)."""
    from list_tpu_torch.infer.pipeline import test_all
    paths = [ranks.result('sweep', r) for r in range(WORLD)]
    assert [os.path.basename(p) for p in paths] == ['03001627_p0.csv',
                                                     '03001627_p1.csv']
    monkeypatch.setenv('LIST_TPU_EVAL_WORKERS', '1')
    monkeypatch.setenv('LIST_TPU_NATIVE_THREADS', '1')
    np.random.seed(0)
    one = test_all(default_config(**setup['sweep1']), device='cpu')
    assert os.path.basename(one) == '03001627.csv'
    header, ref = _csv_rows(one)
    ref = {r[1]: r[2:] for r in ref if r[1] != 'Mean'}
    got = {}
    for rank, p in enumerate(paths):
        h, rows = _csv_rows(p)
        assert h == header and rows[-1][1] == 'Mean'
        ids = [r[1] for r in rows[:-1]]
        assert ids == sorted(ref)[rank::WORLD]
        got.update({r[1]: r[2:] for r in rows[:-1]})
    assert got.keys() == ref.keys() and len(ref) == 2
    for k, row in ref.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(row, np.float64), rtol=7e-2,
                                   atol=2e-2)


# ---- the split dense decode ---------------------------------------------------

@pytest.mark.parametrize('R,ranges', [(16, 2), (32, 2), (16, 4)],
                         ids=['16', '32', '16-four-ranges'])
def test_dense_grid_over_two_row_ranges_is_the_grid(R, ranges):
    """dense_grid_sdf over x rows [0, R/2) and [R/2, R) (or four ranges
    of R/4, a four-card split), concatenated, equals the whole grid bit for
    bit, for every head and in f32 and bf16 (the coarse-projected scales
    run at R = 32): the per-range work is the same per-slab work, and the
    coarse term's product keeps its rows."""
    from list_tpu_torch.ops.dense_grid import dense_grid_sdf
    torch.manual_seed(0)
    m = LIST(**dict(TINY, vox_res=R)).eval()
    img = torch.as_tensor(np.random.RandomState(0).rand(1, 32, 32, 3)
                          .astype(np.float32))
    with torch.no_grad():
        enc = m.encode(img)
    args = (m.sdf_decoder, enc['vox_feat'], enc['feat_l2'], enc['trans_mat'],
            R)
    for dt in (torch.float32, torch.bfloat16):
        for head in (0, 1, 2):
            kw = dict(slab=R // 4, compute_dtype=dt, use_pallas=head)
            whole = dense_grid_sdf(*args, **kw)
            rows = R // ranges
            split = torch.cat([dense_grid_sdf(*args, x_range=(i * rows,
                                                              (i + 1) * rows),
                                              **kw) for i in range(ranges)])
            assert torch.equal(split, whole), (dt, head)
    with pytest.raises(ValueError, match='x_range'):
        dense_grid_sdf(*args, slab=R // 4, x_range=(1, R))


@pytest.mark.parametrize('mesh_shape', [[4], [1, 4]])
def test_four_way_split_is_the_jax_packages(mesh_shape):
    """--mesh_shape 4 and --mesh_shape 1 4 give the dense decode four
    devices (the CPU four times here; cuda:0 .. 3 on a machine with four
    cards), and the four-way plan is list_tpu's: slab 32 at 128^3 and 8
    at 256^3 (the CPU's head 0 on both sides)."""
    from list_tpu.train.executors import LISTExecutor as JaxExecutor
    tex = LISTExecutor(default_config(**dict(PREDICT_CFG,
                                             mesh_shape=mesh_shape)),
                       LIST(**TINY), device='cpu')
    assert tex.decode_devices == [torch.device('cpu')] * 4
    for R, slab in ((128, 32), (256, 8)):
        jax_self = types.SimpleNamespace(vox_res=R, config=tex.config)
        assert JaxExecutor._dense_plan(jax_self, 4)[:2] == (slab, 0)
        assert tex._dense_plan(4, vox_res=R) == (slab, 0)


def test_predict_grid_split_matches_the_jax_package(ranks):
    """predict_grid with --mesh_shape 2 on ['cpu', 'cpu'] (encode once,
    one x-row range per device, slab 8 by the JAX package's ndev rule)
    against list_tpu's predict_grid on a 2-device mesh (its shard_map over
    the slabs; ``_JAX_REFERENCE``) from the same weights, bf16 compute on
    both: atol 5e-4, rtol 2e-2, the tolerance of test_torch_slice.py's
    test_predict_grid_matches (the packages round bf16 intermediates at
    different places)."""
    variables, ref = ranks.jax_reference()['predict']
    tm = load_flax_variables(LIST(**TINY), variables)
    tex = LISTExecutor(default_config(**PREDICT_CFG), tm, device='cpu')
    assert tex.decode_devices == [torch.device('cpu')] * 2
    assert tex._dense_plan(2) == (8, 0)
    got = tex.predict_grid(PREDICT_IMAGE, fetch_dtype='float32',
                           fetch_mode='grid')
    assert got.shape == ref.shape == (16, 16, 16)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=2e-2)
    assert (ref > 0).any() and (ref < 0).any()


# ---- offline evaluation ---------------------------------------------------------

def test_offline_evaluation_scripts_match_the_jax_package(tmp_path):
    """evaluation/evaluate_torch.py and evaluation/evaluate_gather_torch.py
    on tests/test_offline_eval.py's tree give list_tpu's evaluate_main /
    gather_main pickles, mean and median pickles and CSV exactly (one
    worker each, np.random seeded alike: the metrics sample points)."""
    from list_tpu.eval.offline import evaluate_main, gather_main
    from list_tpu.utils.meshio import make_icosphere
    gen, gt = tmp_path / 'gen', tmp_path / 'gt'
    for i, r in enumerate((0.3, 0.35)):
        shape = f'shape{i}'
        (gen / '03001627' / shape).mkdir(parents=True)
        (gt / '03001627' / shape).mkdir(parents=True)
        make_icosphere(2, r).export(
            str(gen / '03001627' / shape / '00_pred.obj'))
        make_icosphere(2, r * 1.05).export(
            str(gt / '03001627' / shape / 'isosurf_scaled.obj'))
    common = ['--gen_dir', str(gen), '--mesh_dir', str(gt), '--n_points',
              '2000', '--workers', '1']
    np.random.seed(0)
    assert evaluate_main(common + ['--out_dir', str(tmp_path / 'jax')]) == 2
    gather_main(['--eval_dir', str(tmp_path / 'jax')])
    env = dict(os.environ, OMP_NUM_THREADS='1')
    seeded = ('import sys, runpy, numpy; numpy.random.seed(0); '
              'sys.argv = sys.argv[1:]; '
              'runpy.run_path(sys.argv[0], run_name="__main__")')
    for script, args in (
            ('evaluate_torch.py', common + ['--out_dir',
                                            str(tmp_path / 'port')]),
            ('evaluate_gather_torch.py', ['--eval_dir',
                                          str(tmp_path / 'port')])):
        r = subprocess.run([sys.executable, '-c', seeded,
                            os.path.join(REPO, 'evaluation', script), *args],
                           cwd=str(tmp_path), env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port'))
    assert len([n for n in names if n.startswith('eval_')]) == 2
    for n in names:
        a = (tmp_path / 'jax' / n).read_bytes()
        b = (tmp_path / 'port' / n).read_bytes()
        if n.endswith('.pkl'):
            assert pickle.loads(a) == pickle.loads(b), n
        else:
            assert a == b, n


if __name__ == '__main__':
    _rank_main(sys.argv[1])
