"""Guards of the PyTorch/CUDA port: it loads no JAX, never drops to the CPU
on its own, and its weight bridge is strict."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    """Importing the port, its entry scripts infer_torch.py,
    train_torch.py, evaluation/evaluate_torch.py,
    evaluation/evaluate_gather_torch.py, preprocessing/preprocess_torch.py
    and preprocessing/farthest_pointcloud_torch.py, and everything
    chip_smoke.py imports, loads no
    jax/flax/optax module, no module of the JAX package (``list_tpu``
    or ``list_tpu.*`` -- ``list_tpu_torch`` itself must not trip the
    check) and no h5py (the port's HDF5 files go through
    ``list_tpu_torch/utils/h5.py``)."""
    code = (
        'import sys, ast\n'
        'import list_tpu_torch, list_tpu_torch.models, list_tpu_torch.train\n'
        'import list_tpu_torch.bridge, list_tpu_torch.config\n'
        'import list_tpu_torch.ops.dense_grid\n'
        'import list_tpu_torch.ops.cuda.stencil3d\n'
        'import list_tpu_torch.ops.cuda.fused_fc0\n'
        'import list_tpu_torch.ops.cuda.build, list_tpu_torch.native\n'
        'import list_tpu_torch.eval, list_tpu_torch.utils\n'
        'import list_tpu_torch.data, list_tpu_torch.ops.losses\n'
        'import list_tpu_torch.train.state, list_tpu_torch.models.norm\n'
        'import list_tpu_torch.ops.band, list_tpu_torch.registry\n'
        'import list_tpu_torch.infer.pipeline, list_tpu_torch.data.shapenet\n'
        'import list_tpu_torch.train.checkpoints\n'
        'import list_tpu_torch.train.trainer\n'
        'import list_tpu_torch.utils.flax_msgpack\n'
        'import list_tpu_torch.utils.logging\n'
        'import list_tpu_torch.data.transforms, infer_torch\n'
        'import list_tpu_torch.train.split_coarse\n'
        'import list_tpu_torch.data.loader, list_tpu_torch.utils.torch_port\n'
        'import train_torch\n'
        'import list_tpu_torch.parallel.multihost\n'
        'import list_tpu_torch.parallel.mesh, list_tpu_torch.eval.offline\n'
        'import list_tpu_torch.data.pix3d, list_tpu_torch.data.preprocess\n'
        'import list_tpu_torch.ops.fps, list_tpu_torch.ops.projection\n'
        'import list_tpu_torch.utils.h5\n'
        'sys.path.insert(0, "evaluation")\n'
        'import evaluate_torch, evaluate_gather_torch\n'
        'sys.path.insert(0, "preprocessing")\n'
        'import preprocess_torch, farthest_pointcloud_torch\n'
        'src = open("chip_smoke.py").read()\n'
        'for node in ast.walk(ast.parse(src)):\n'
        '    if isinstance(node, ast.Import):\n'
        '        for a in node.names: __import__(a.name)\n'
        '    elif isinstance(node, ast.ImportFrom) and node.level == 0:\n'
        '        __import__(node.module)\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",\n'
        '                                    "list_tpu", "h5py"))\n'
        'print("BAD", bad)\n'
        'sys.exit(1 if bad else 0)\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_executor_without_device_refuses_cpu_fallback():
    """No device -> cuda; on a host without CUDA that raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is honoured')
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    cfg = default_config(vox_res=8, point_feat=[128, 8, 3],
                         point_degree=[2, 2], im_enc_layers=[1, 1, 1, 1, 2])
    model = LIST.from_config(cfg)
    with pytest.raises(RuntimeError, match='cuda'):
        LISTExecutor(cfg, model)
    with pytest.raises(RuntimeError, match='cuda'):
        LISTExecutor(cfg, model, device='cuda')


def _pointmlp_pair():
    from list_tpu.models.pointmlp import PointMLP as JPointMLP
    from list_tpu_torch.models.pointmlp import PointMLP
    jm = JPointMLP()
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4, 3), np.float32))
    v = jax.tree.map(np.asarray, v)
    return jm, v, PointMLP()


def test_bridge_loads_and_matches():
    jm, v, tm = _pointmlp_pair()
    from list_tpu_torch.bridge import load_flax_variables
    rng = np.random.RandomState(0)
    # non-trivial running statistics so the mean/var mapping is exercised
    stats = jax.tree.map(lambda a: rng.rand(*a.shape).astype(np.float32)
                         + 0.5, v['batch_stats'])
    v = {'params': v['params'], 'batch_stats': stats}
    load_flax_variables(tm, v)
    x = rng.randn(2, 5, 3).astype(np.float32)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('edit', ['missing', 'extra', 'shape'])
def test_bridge_rejects_bad_tree(edit):
    jm, v, tm = _pointmlp_pair()
    from list_tpu_torch.bridge import load_flax_variables
    params = {k: dict(m) for k, m in v['params'].items()}
    if edit == 'missing':
        del params['block2_conv']['bias']
    elif edit == 'extra':
        params['block9_conv'] = {'kernel': np.zeros((3, 4), np.float32)}
    else:
        params['block1_conv']['kernel'] = np.zeros((4, 64), np.float32)
    bad = {'params': params, 'batch_stats': v['batch_stats']}
    with pytest.raises((KeyError, ValueError)):
        load_flax_variables(tm, bad)
