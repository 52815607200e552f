"""The port's offline preprocessing on the CPU against the JAX package:
``data/preprocess.py`` (SDF sampling; ``list_tpu/data/preprocess.py``),
farthest-point sampling (``ops/fps.py``; ``list_tpu/ops/fps.py``) and
``run_fps``, the two preprocessing CLIs, and the projection helpers
(``ops/projection.py``; ``list_tpu/ops/projection.py``)."""

import os
import runpy
import shutil
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.data import preprocess as j_preprocess
from list_tpu.ops import projection as j_projection
from list_tpu.ops.fps import farthest_point_sampling as j_fps
from list_tpu_torch.data import preprocess
from list_tpu_torch.data.synthetic import SyntheticShape
from list_tpu_torch.ops import projection
from list_tpu_torch.ops.fps import (farthest_point_sampling,
                                    sample_farthest_points)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMAS = (0.003, 0.01, 0.07)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread, restored after: the port's FPS is
    thousands of small operations a cloud, and beside the other test
    workers torch's threads wait on one another; the 50,000-point case
    took 724 s there against 2.6 s alone on one thread, with the same
    indices."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h5(fn):
    """{dataset: (dtype, shape, compression, bytes)} of an h5 file."""
    with h5py.File(fn, 'r') as f:
        return {k: (str(f[k].dtype), f[k].shape, f[k].compression,
                    f[k][:].tobytes()) for k in f.keys()}


def _raw_mesh(root, n=1, seed=5):
    """Raw meshes at <root>/raw/chair/model<i>.model/model.obj (off-centre
    and scaled, so scale_mesh has work to do); returns their paths."""
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        mesh = SyntheticShape(rng).mesh(32)
        mesh.apply_scale(2.5).apply_translation([0.3, -0.1, 0.7])
        d = os.path.join(root, 'raw', 'chair', f'model{i:03d}.model')
        os.makedirs(d)
        paths.append(os.path.join(d, 'model.obj'))
        mesh.export(paths[-1])
    return paths


def test_run_writes_the_jax_packages_files(tmp_path):
    """preprocess.run on one mesh at num_points 2,000: the same
    isosurf_scaled.obj bytes and the same sampled_points.h5 datasets
    (grid_points and one per sigma: dtype, shape, gzip, bytes) as
    list_tpu.data.preprocess.run; a second run skips the shape."""
    (path,) = _raw_mesh(str(tmp_path))
    outs = {}
    for name, run in (('jax', j_preprocess.run), ('torch', preprocess.run)):
        out = str(tmp_path / name)
        run(path, out, SIGMAS, 2000)
        sp = os.path.join(out, 'sampled_points', 'chair', 'model000.model',
                          'sampled_points.h5')
        with open(os.path.join(out, 'isosurface', 'chair', 'model000.model',
                               'isosurf_scaled.obj'), 'rb') as f:
            outs[name] = (f.read(), _h5(sp), os.path.getmtime(sp))
    assert outs['torch'][0] == outs['jax'][0]
    assert outs['torch'][1] == outs['jax'][1]
    got = outs['torch'][1]
    assert sorted(got) == ['grid_points'] + [f'query_points_sigma_{s}'
                                             for s in SIGMAS]
    assert got['grid_points'][1] == (2000, 3)
    assert got['query_points_sigma_0.07'][1:3] == ((2000, 4), 'gzip')
    preprocess.run(path, str(tmp_path / 'torch'), SIGMAS, 2000)
    assert os.path.getmtime(os.path.join(
        str(tmp_path / 'torch'), 'sampled_points', 'chair', 'model000.model',
        'sampled_points.h5')) == outs['torch'][2]


def _grid_points():
    g = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing='ij'), -1)
    return g.reshape(-1, 3).astype(np.float32) / 9


@pytest.mark.parametrize('case', [
    ('gauss', 1200, 256, 0), ('gauss', 1200, 256, 17),
    ('grid ties', 1000, 200, 0), ('published shape', 50000, 5000, 0)])
def test_fps_indices_are_the_jax_packages(case):
    """Indices identical to list_tpu.ops.fps.farthest_point_sampling's:
    seeded points at N = 1,200, k = 256 from two starts, a 10^3 lattice
    (ties go to the first index), and the published shape N = 50,000,
    k = 5,000, where the squared distance must round as XLA's CPU fma
    does."""
    name, n, k, start = case
    pts = (_grid_points() if name == 'grid ties'
           else np.random.RandomState(n + k).randn(n, 3).astype(np.float32))
    assert len(pts) == n
    want = np.asarray(j_fps(jnp.asarray(pts), k, start))
    got = farthest_point_sampling(torch.as_tensor(pts), k, start)
    assert got.dtype == torch.int64 and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sample_farthest_points(torch.as_tensor(pts), k).numpy(),
        pts[np.asarray(j_fps(jnp.asarray(pts), k))])


def _fps_tree(root, n_shapes=2, n_points=6000):
    """<root>/chair/<shape>/sampled_points.h5 with seeded grid_points."""
    rng = np.random.RandomState(9)
    for i in range(n_shapes):
        d = os.path.join(root, 'chair', f'synth{i:04d}')
        os.makedirs(d)
        with h5py.File(os.path.join(d, 'sampled_points.h5'), 'w') as f:
            f.create_dataset('grid_points', data=rng.randn(n_points, 3))


def test_run_fps_writes_the_jax_packages_file(tmp_path):
    """run_fps(device='cpu') over two shapes writes the same
    farthest_pointclouds.h5['points_5000'] (dtype, shape, gzip, bytes) as
    the JAX package's run_fps on a copy of the tree, skips shapes already
    done, and the port's IM2PointFarthest reads it."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import IM2PointFarthest
    from PIL import Image
    a, b = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    _fps_tree(a)
    shutil.copytree(a, b)
    assert j_preprocess.run_fps(a) == 2
    assert preprocess.run_fps(b, device='cpu') == 2
    assert preprocess.run_fps(b, device='cpu') == 0
    for s in ('synth0000', 'synth0001'):
        fn = os.path.join('chair', s, 'farthest_pointclouds.h5')
        got, want = _h5(os.path.join(b, fn)), _h5(os.path.join(a, fn))
        assert got == want and got['points_5000'][1:3] == ((5000, 3), 'gzip')
        img_dir = tmp_path / 'images' / 'chair' / s / 'easy'
        img_dir.mkdir(parents=True)
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
            img_dir / '00.png')
    split = tmp_path / 'split'
    split.mkdir()
    (split / 'chair_train.lst').write_text('synth0000\nsynth0001\n')
    cfg = default_config(catlist=['chair'], image_dir=str(tmp_path / 'images')
                         + '/', h5_dir=b + '/', split_dir=str(split),
                         viewnum=1, img_res=32)
    ds = IM2PointFarthest(cfg, 'train')
    assert len(ds) == 2
    with h5py.File(os.path.join(b, 'chair', 'synth0000',
                                'farthest_pointclouds.h5'), 'r') as f:
        np.testing.assert_array_equal(ds[0]['pc'],
                                      f['points_5000'][:].astype(np.float32))


def test_run_fps_refuses_cpu_fallback(tmp_path):
    """No device -> cuda; on a host without CUDA run_fps raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is honoured')
    _fps_tree(str(tmp_path), n_shapes=1, n_points=10)
    with pytest.raises(RuntimeError, match='cuda'):
        preprocess.run_fps(str(tmp_path))


def test_preprocessing_clis(tmp_path, monkeypatch):
    """preprocessing/preprocess_torch.py then
    preprocessing/farthest_pointcloud_torch.py --device cpu over a raw tree
    of two meshes: each shape gets its isosurf_scaled.obj,
    sampled_points.h5 and farthest_pointclouds.h5['points_256']."""
    _raw_mesh(str(tmp_path), n=2)
    out = str(tmp_path / 'out')
    for script, argv in (
            ('preprocess_torch.py', [
                '--input_dir', str(tmp_path / 'raw') + '/', '--output_dir',
                out, '--categories', 'chair', '--file_path_glob',
                '/*/model.obj', '--num_points', '600', '--workers', '1']),
            ('farthest_pointcloud_torch.py', [
                '--h5_dir', os.path.join(out, 'sampled_points'), '--k', '256',
                '--device', 'cpu'])):
        path = os.path.join(REPO, 'preprocessing', script)
        monkeypatch.setattr(sys, 'argv', [path] + argv)
        runpy.run_path(path, run_name='__main__')
    for i in range(2):
        sub = os.path.join('chair', f'model{i:03d}.model')
        assert os.path.exists(os.path.join(out, 'isosurface', sub,
                                           'isosurf_scaled.obj'))
        assert _h5(os.path.join(out, 'sampled_points', sub,
                                'sampled_points.h5'))['grid_points'][1] \
            == (600, 3)
        assert _h5(os.path.join(out, 'sampled_points', sub,
                                'farthest_pointclouds.h5'))['points_256'][1] \
            == (256, 3)


def test_projection_helpers_are_the_jax_packages():
    """The five helpers on seeded inputs: floats at 1e-6 (f32), pixels and
    gathered features exact, int32 pixels truncated toward zero (negative
    and beyond-the-image coordinates included) then clamped."""
    rng = np.random.RandomState(3)
    b, n, res = 2, 300, 64
    pts = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    tm = rng.randn(b, 4, 3).astype(np.float32)
    want = np.asarray(j_projection.transform_points(jnp.asarray(pts),
                                                    jnp.asarray(tm)))
    got = projection.transform_points(torch.as_tensor(pts),
                                      torch.as_tensor(tm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # camera-space points whose pixels straddle both edges of the image
    depth = rng.uniform(0.5, 2.0, (b, n, 1)).astype(np.float32)
    xy = rng.uniform(-20, res + 20, (b, n, 2)).astype(np.float32)
    hp = np.concatenate([xy * depth, depth], -1)
    homo = torch.as_tensor(hp)
    pix = projection.project_points_to_pixels(homo, res)
    pix_j = np.asarray(j_projection.project_points_to_pixels(
        jnp.asarray(hp), res))
    assert pix.dtype == torch.int32
    np.testing.assert_array_equal(pix.numpy(), pix_j)
    assert (pix_j == 0).any() and (pix_j == res - 1).any()
    uv, z = projection.project_points_to_uv(homo, res)
    uv_j, depth_j = j_projection.project_points_to_uv(jnp.asarray(hp), res)
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(z.numpy(), np.asarray(depth_j))
    raw = rng.randint(-20, res + 20, (b, n, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        projection.check_points(torch.as_tensor(raw), res).numpy(),
        np.asarray(j_projection.check_points(jnp.asarray(raw), res)))
    feat = rng.randn(b, res, res, 5).astype(np.float32)
    np.testing.assert_array_equal(
        projection.sample_features_by_pixels(torch.as_tensor(feat),
                                             pix).numpy(),
        np.asarray(j_projection.sample_features_by_pixels(
            jnp.asarray(feat), jnp.asarray(pix_j))))
