"""The whole slice on the CPU: image -> dense SDF grid -> mesh -> metrics,
the JAX package's LISTExecutor against the port's, with the same (bridged)
weights of the tiny LIST (R=16)."""

import copy

import jax
import numpy as np
import pytest
import torch

from list_tpu.config import default_config as j_default_config
from list_tpu.config import get_args as j_get_args
from list_tpu.eval.metrics import eval_mesh as j_eval_mesh
from list_tpu.models import LIST as JLIST
from list_tpu.train import LISTExecutor as JExecutor
from list_tpu.utils.meshing import generate_mesh as j_generate_mesh
from list_tpu_torch.bridge import load_flax_variables
from list_tpu_torch.config import default_config, get_args
from list_tpu_torch.eval.metrics import eval_mesh
from list_tpu_torch.models import LIST
from list_tpu_torch.ops.band import BandGrid, band_decode, band_to_numpy
from list_tpu_torch.train import LISTExecutor
from list_tpu_torch.utils.meshing import generate_mesh
from list_tpu_torch.utils.meshio import make_icosphere

CFG = dict(vox_res=16, img_res=32, train_batch_size=1,
           point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
           im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
           test_pointnum=1024, fetch_mode='grid')
TINY = dict(vox_res=16, point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4),
            im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)
GRID = dict(fetch_dtype='float32', fetch_mode='grid')


@pytest.fixture(scope='module')
def executors():
    img = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    jex = JExecutor(j_default_config(**CFG), JLIST(**TINY))
    jex.init_state({'rgb_image': img})
    # weight choice: shift fc_out's bias so the first grid's median is zero
    # (random weights give a field without a zero crossing)
    med = float(np.median(jex.predict_grid(img, **GRID)))
    params = jax.tree.map(np.asarray, jex.state.params)
    params['sdf_decoder']['fc_out']['bias'] = (
        params['sdf_decoder']['fc_out']['bias'] - med * CFG['sdf_scale'])
    jex.state = jex.state.replace(params=params)
    tm = LIST(**TINY)
    load_flax_variables(tm, {'params': params, 'batch_stats': jax.tree.map(
        np.asarray, jex.state.batch_stats)})
    tex = LISTExecutor(default_config(**CFG), tm, device='cpu')
    return img, jex, tex


def test_predict_grid_matches(executors):
    """predict_grid, bf16 compute on both sides (the executors' production
    dtype): atol 5e-4, rtol 2e-2 on the sdf_scale-divided grid (values up
    to ~0.03 here).  Reason: the two packages round bf16 intermediates
    (tap resamples, percep lerps, ReLU recasts) at different places -- XLA
    on the CPU evaluates fused bf16 elementwise chains in f32 -- and each
    rounding is up to 2^-9 relative."""
    img, jex, tex = executors
    ref = jex.predict_grid(img, **GRID)
    got = tex.predict_grid(img, **GRID)
    assert got.shape == ref.shape == (16, 16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=2e-2)
    assert (ref > 0).any() and (ref < 0).any()


def test_chunked_fallback_matches_dense(executors):
    """fast_grid=0 (the general gather decoder over test_pointnum chunks)
    gives the dense decode's grid: f32 compute on both, atol 2e-5 (the
    grid is sdf_scale-divided)."""
    img, _, tex = executors
    tex32 = LISTExecutor(tex.config, tex.model, device='cpu',
                         compute_dtype=torch.float32)
    a = tex32.predict_grid(img, fast=True, **GRID)
    b = tex32.predict_grid(img, fast=False, **GRID)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize('wire', ['bfloat16', 'float32'])
def test_band_fetch_gives_the_grid_fetch_mesh(executors, wire):
    """predict_grid with --fetch_mode band rebuilds a grid whose marching
    cubes mesh is identical (vertices and faces) to the grid fetch's, with
    the same classes everywhere; device_out gives the BandGrid.  fc_out's
    bias is set so that 3% of the grid is negative: the fixture's median
    surface is too large for the band's capacity at R = 16 (an overflow
    fetches the full grid)."""
    img, _, tex = executors
    model = copy.deepcopy(tex.model)
    with torch.no_grad():
        model.sdf_decoder.fc_out.bias -= CFG['sdf_scale'] * float(
            np.quantile(tex.predict_grid(img, **GRID), 0.03))
    ex = LISTExecutor(tex.config, model, device='cpu')
    full = ex.predict_grid(img, fetch_dtype=wire, fetch_mode='grid')
    out = ex.predict_grid(img, fetch_dtype=wire, fetch_mode='band',
                          device_out=True)
    assert isinstance(out, BandGrid)
    rec = band_decode(band_to_numpy(out.band), 16, wire)
    assert rec is not None  # no overflow: the band itself was decoded
    np.testing.assert_array_equal(rec > 0, full > 0)
    a = generate_mesh(full, -0.5, 0.5)
    b = generate_mesh(ex.predict_grid(img, fetch_dtype=wire,
                                      fetch_mode='band'), -0.5, 0.5)
    assert len(a[0]) > 10
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])


def test_predict_grid_batch_matches(executors):
    """predict_grid_batch: one two-image encode, then one decode each,
    gives each image's predict_grid (f32 compute, atol 1e-5: the batch-2
    encode sums the convolutions in another order on the CPU); with
    device_out, a list of one device result per image."""
    img, _, tex = executors
    ex = LISTExecutor(tex.config, tex.model, device='cpu',
                      compute_dtype=torch.float32)
    imgs = np.concatenate([img, img[:, ::-1]])
    got = ex.predict_grid_batch(imgs, **GRID)
    assert got.shape == (2, 16, 16, 16) and got.dtype == np.float32
    for i in range(2):
        np.testing.assert_allclose(
            got[i], ex.predict_grid(imgs[i:i + 1], **GRID), atol=1e-5,
            rtol=0)
    outs = ex.predict_grid_batch(imgs, device_out=True, **GRID)
    assert len(outs) == 2 and all(isinstance(o, torch.Tensor) for o in outs)


def test_executor_test_under_the_default_config(executors):
    """LISTExecutor.test under default_config's --fetch_mode band and bf16
    wire (no fetch overrides) serves a request."""
    img, _, tex = executors
    cfg = default_config(**{k: v for k, v in CFG.items()
                            if k != 'fetch_mode'})
    assert (cfg.fetch_mode, cfg.fetch_dtype) == ('band', 'bfloat16')
    ex = LISTExecutor(cfg, tex.model, device='cpu')
    (mesh, values), _ = ex.test({'rgb_image': img})
    assert len(mesh.vertices) > 10 and values.dtype == np.float32


def test_mesh_and_metrics_identical(executors):
    """The port's copied generate_mesh and eval_mesh give results
    identical to list_tpu's on the same grid and rng."""
    img, jex, _ = executors
    grid = jex.predict_grid(img, **GRID)
    jv, jf = j_generate_mesh(grid, -0.5, 0.5)
    tv, tf = generate_mesh(grid, -0.5, 0.5)
    assert len(tv) > 10
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    gt = make_icosphere(radius=0.3)
    jm = j_generate_mesh(grid, -0.5, 0.5, as_trimesh_obj=True)
    tm = generate_mesh(grid, -0.5, 0.5, as_trimesh_obj=True)
    a = j_eval_mesh(jm, gt, -0.5, 0.5, n_points=2000,
                    rng=np.random.RandomState(7))
    b = eval_mesh(tm, gt, -0.5, 0.5, n_points=2000,
                  rng=np.random.RandomState(7))
    assert a == b and 'iou' in b


def test_executor_test_serves_a_request(executors):
    """LISTExecutor.test with eval_pred: a non-empty mesh and finite
    metrics, with the predict's timings recorded."""
    img, _, tex = executors
    batch = {'rgb_image': img, 'gt_mesh': make_icosphere(radius=0.3)}
    np.random.seed(0)
    (mesh, values), score = tex.test(batch, eval_pred=True)
    assert len(mesh.vertices) > 10 and len(mesh.faces) > 0
    assert values.shape == (16, 16, 16)
    assert score and all(np.isfinite(v) for v in score.values())
    assert set(tex.timings) == {'encode_s', 'decode_s'}


@pytest.mark.parametrize('argv', [
    [],
    ['--vox_res', '64', '--point_feat', '128', '8', '3', '--point_degree',
     '2', '4', '--fetch_dtype', 'float32', '--catlist', '03001627',
     '--exp_name', 'x', '--use_pallas', '2']])
def test_config_same_flags_and_defaults(argv):
    """The port's argparse copy parses every command line to the JAX
    package's namespace."""
    assert vars(get_args(argv)) == vars(j_get_args(argv))


def test_dense_plan_follows_the_jax_package():
    """_dense_plan -> (slab, use_pallas) on the cases of the JAX package's
    test_dense_plan_selection, with the card standing in for the TPU: the
    slabs are the JAX package's, the CPU always takes the XLA head (0), and
    the card the head --use_pallas names, with K1 (2) for -1 at every R:
    one slab at R <= 128 (any R, as K1 needs no tile), the JAX slab
    preference above."""
    from types import SimpleNamespace

    def plan(vox_res, use_pallas=-1, device='cpu'):
        fake = SimpleNamespace(vox_res=vox_res, device=torch.device(device),
                               config=SimpleNamespace(use_pallas=use_pallas))
        return LISTExecutor._dense_plan(fake)

    assert plan(128) == (64, 0)
    assert plan(256) == (8, 0)
    assert plan(15) == (None, 0)
    assert plan(128, use_pallas=2) == (64, 0)
    assert plan(128, use_pallas=1) == (64, 0)

    def card(*a, **kw):
        return plan(*a, device='cuda', **kw)

    assert card(128) == (128, 2)
    assert card(64) == (64, 2)
    assert card(120) == (120, 2)
    assert card(127) == (127, 2)
    assert card(15) == (15, 2)
    assert card(128, use_pallas=2) == (128, 2)
    assert card(128, use_pallas=0) == (64, 0)
    assert card(128, use_pallas=1) == (64, 1)
    assert card(192) == (64, 2)
    assert card(256) == (8, 2)
    assert card(256, use_pallas=0) == (8, 0)
    assert card(256, use_pallas=1) == (8, 1)
    assert card(250) == (2, 2)
    assert card(255) == (None, 0)
