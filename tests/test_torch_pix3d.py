"""The port's Pix3D reader (``list_tpu_torch/data/pix3d.py``) on the CPU
against the JAX package's (``list_tpu/data/pix3d.py``): both read one
synthetic Pix3D tree, preprocessed by the port, at the same path (the
occupancy cache lives in the tree and its seed hashes the absolute path,
so two copies would not do), with the cache deleted before each
package's run; then the port's ``train()`` and ``test_all()`` on that
tree, and the Pix3D two-stage recipe (``coarse_prediciton_Pix3D`` ->
``split_coarse`` -> ``list_Pix3D --warm_start``), at
``tests/test_pix3d.py``'s tiny sizes."""

import glob
import os

import h5py
import numpy as np
import pytest
import torch

from list_tpu.config import default_config as j_default_config
from list_tpu.data import Pix3D as JPix3D
from list_tpu_torch import registry
from list_tpu_torch.config import default_config
from list_tpu_torch.data import Pix3D, generate_synthetic_pix3d, preprocess

N_SHAPES = 3
READER = dict(catlist=['chair'], vox_res=16, img_res=32,
              sample_point_density=128, coarse_point_density=500)
TINY = dict(READER, point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
            im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
            train_batch_size=2, epochs=1, save_every_epoch=1,
            test_every_epoch=100, test_pointnum=512, num_workers=2,
            testlist_file='', chunk_l=0)


@pytest.fixture(scope='module')
def pix3d_root(tmp_path_factory):
    """A raw synthetic Pix3D tree of 3 shapes (the test split: the first
    2), preprocessed by the port at 1,200 surface points."""
    root = str(tmp_path_factory.mktemp('pix3d_torch'))
    for path in generate_synthetic_pix3d(root, n_shapes=N_SHAPES, n_test=2,
                                         img_res=64, mesh_res=32):
        preprocess.run(path, os.path.join(root, 'data'),
                       (0.003, 0.01, 0.07), 1200)
    return root


def _clear_caches(root):
    for f in glob.glob(os.path.join(root, 'data', 'sampled_points', '*', '*',
                                    'occupancies.h5')):
        os.remove(f)


def _caches(root):
    """Every occupancy cache of the tree: {file: {key: (dtype, shape,
    compression, bytes)}}."""
    out = {}
    for fn in sorted(glob.glob(os.path.join(
            root, 'data', 'sampled_points', '*', '*', 'occupancies.h5'))):
        with h5py.File(fn, 'r') as f:
            out[fn] = {k: (str(f[k].dtype), f[k].shape, f[k].compression,
                           f[k][:].tobytes()) for k in f.keys()}
    return out


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == 'gt_mesh':
            np.testing.assert_array_equal(b[k].vertices, a[k].vertices)
            np.testing.assert_array_equal(b[k].faces, a[k].faces)
        elif isinstance(a[k], np.ndarray):
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_items_are_the_jax_packages(pix3d_root, mode):
    """Same tree, same seed: the datalists are equal and every item
    (rgb_image, points, values, occ, pc) is bit-identical, the train split
    with the flip and colour jitter drawn from the same generator; each
    reader writes the occupancy caches itself (deleted before its run),
    and the caches it leaves are equal too."""
    kw = dict(READER, data_dir=pix3d_root, seed=7,
              random_h_flip=mode == 'train', color_jitter=mode == 'train')
    runs = []
    for reader, cfg in ((JPix3D, j_default_config(**kw)),
                        (Pix3D, default_config(**kw))):
        _clear_caches(pix3d_root)
        ds = reader(cfg, mode)
        items = [ds[i] for i in range(len(ds))] + [ds[0]]  # a second draw
        runs.append((ds.datalist, items, _caches(pix3d_root)))
    (jlist, jitems, jcache), (tlist, titems, tcache) = runs
    assert tlist == jlist and len(tlist) == (N_SHAPES if mode == 'train'
                                             else 2)
    assert titems[0]['rgb_image'].shape == (32, 32, 3)
    for a, b in zip(jitems, titems):
        _same_item(a, b)
    assert tcache == jcache and len(tcache) == len(tlist)


def test_get_testdata_is_the_jax_packages(pix3d_root):
    """get_testdata over the test split, twice (the coarse choice draws
    from the reader's own RandomState(333)): image, pc, ids and the ground
    truth mesh's vertices and faces bit-identical."""
    kw = dict(READER, data_dir=pix3d_root)
    jds, tds = JPix3D(j_default_config(**kw), 'test'), \
        Pix3D(default_config(**kw), 'test')
    for _ in range(2):
        for info in tds.datalist:
            args = (info['cat_id'], info['shape_id'],
                    os.path.splitext(info['img_id'])[0])
            a, b = jds.get_testdata(*args), tds.get_testdata(*args)
            assert b['rgb_image'].shape == (1, 32, 32, 3)
            assert len(b['gt_mesh'].faces) > 10
            _same_item(a, b)


def test_ensure_occupancies_writes_the_jax_packages_caches(pix3d_root):
    """ensure_occupancies from an empty cache: the same keys, dtypes,
    shapes, compression and bytes as the JAX package's (each entry seeded
    by the seed and the query file's path); then items read the cache
    without writing it."""
    kw = dict(READER, data_dir=pix3d_root, seed=11)
    _clear_caches(pix3d_root)
    JPix3D(j_default_config(**kw), 'train').ensure_occupancies()
    want = _caches(pix3d_root)
    _clear_caches(pix3d_root)
    ds = Pix3D(default_config(**kw), 'train')
    ds.ensure_occupancies()
    got = _caches(pix3d_root)
    assert got == want and len(got) == N_SHAPES
    mtimes = {f: os.path.getmtime(f) for f in got}
    for i in range(len(ds)):
        assert ds[i]['occ'].shape == (16, 16, 16)
    assert {f: os.path.getmtime(f) for f in got} == mtimes


def test_registry_resolves_pix3d_to_the_port():
    for name in ('datasets.Datasets.Pix3D', 'Pix3D',
                 'list_tpu_torch.data.Pix3D'):
        assert registry.get_class(name) is Pix3D


@pytest.fixture(scope='module')
def two_stage(pix3d_root, tmp_path_factory):
    """CoarseNet ``-e coarse_prediciton_Pix3D`` 1 epoch, ``split_coarse``,
    LIST ``-e list_Pix3D --warm_start`` 1 epoch, then ``test_all`` of its
    best-train checkpoint, on the CPU; returns the configs, the stage-2
    log and the sweep's CSV."""
    import contextlib
    import io

    from list_tpu_torch.infer.pipeline import test_all
    from list_tpu_torch.train import split_coarse
    from list_tpu_torch.train.trainer import train
    out = str(tmp_path_factory.mktemp('pix3d_runs')) + '/'
    base = dict(TINY, data_dir=pix3d_root, output_dir=out,
                dataset='datasets.Datasets.Pix3D')
    c1 = default_config(**dict(base, model='network.models.CoarseNet',
                               exp_name='coarse_prediciton_Pix3D'))
    train(c1, device='cpu')
    split_coarse.main(['--exp_name', 'coarse_prediciton_Pix3D',
                       '--output_dir', out,
                       '--checkpoint', 'best_model_train.ckpt'])
    c2 = default_config(**dict(base, model='network.models.LIST',
                               exp_name='list_Pix3D', warm_start=True))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train(c2, device='cpu')
    c3 = default_config(**dict(base, model='network.models.LIST',
                               exp_name='list_Pix3D', eval_pred=True,
                               test_checkpoint='best_model_train.ckpt'))
    csv_path = test_all(c3, device='cpu')
    return c1, c2, c3, log.getvalue(), csv_path


def test_warm_start_finds_the_pix3d_coarse_checkpoints(two_stage):
    """'Pix3D' in the experiment name points the warm start at
    coarse_prediciton_Pix3D: both submodule checkpoints load, and after
    the epoch im_encoder and point_decoder are bit-identical to the split
    while im_encoder2 moved."""
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import checkpoints as ckpt
    c1, c2, _, log, _ = two_stage
    assert 'list_Pix3D Im E 1+2 checkpoints loaded' in log
    assert 'list_Pix3D PD checkpoint loaded' in log
    trained, split = LIST.from_config(c2), LIST.from_config(c2)
    ckpt.load_checkpoint(os.path.join(c2.checkpoint_dir,
                                      'best_model_train.ckpt'), trained)
    for name, f in (('im_encoder', 'best_IME_test.ckpt'),
                    ('im_encoder2', 'best_IME_test.ckpt'),
                    ('point_decoder', 'best_PD_test.ckpt')):
        ckpt.load_submodule(os.path.join(c1.checkpoint_dir, f), split, name)
    same = {n: all(torch.equal(a, b) for a, b in zip(
        getattr(trained, n).parameters(), getattr(split, n).parameters()))
        for n in ('im_encoder', 'point_decoder', 'im_encoder2')}
    assert same == {'im_encoder': True, 'point_decoder': True,
                    'im_encoder2': False}


def test_sweep_writes_a_mesh_and_a_row_per_test_image(two_stage):
    """test_all over the Pix3D test split (tests/test_pix3d.py:122-147):
    a mesh per image at <cat>/<model_folder>/<img>_pred.obj and, with
    --eval_pred, a CSV row per image with the <model_folder>_<img> ID and
    the Mean row."""
    _, _, c3, _, csv_path = two_stage
    res = os.path.join(c3.results_dir, 'test_1')
    for i in range(2):
        assert os.path.exists(os.path.join(
            res, 'chair', f'model{i:03d}.model', f'{i:04d}_pred.obj'))
    assert csv_path is not None
    with open(csv_path) as f:
        ids = [line.split(',')[1] for line in f.read().splitlines()[1:]]
    assert ids == ['model000.model_0000', 'model001.model_0001', 'Mean']


def test_pix3d_train_and_sweep_refuse_cpu_fallback(pix3d_root, tmp_path):
    """No device -> cuda; on a host without CUDA train() and test_all()
    on Pix3D raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is honoured')
    from list_tpu_torch.infer.pipeline import test_all
    from list_tpu_torch.train.trainer import train
    cfg = default_config(**dict(TINY, data_dir=pix3d_root,
                                output_dir=str(tmp_path) + '/',
                                model='network.models.LIST',
                                dataset='datasets.Datasets.Pix3D',
                                exp_name='nocard'))
    for fn in (train, test_all):
        with pytest.raises(RuntimeError, match='cuda'):
            fn(cfg)
