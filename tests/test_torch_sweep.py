"""The test-split sweep on the CPU: the JAX package's ``test_all`` and the
port's on one synthetic ShapeNet tree from the same ``.ckpt``; the port's
checkpoint reader, msgpack reader and registry."""

import csv
import os
import shutil

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from list_tpu import registry as j_registry
from list_tpu.config import default_config as j_default_config
from list_tpu.data import generate_synthetic_shapenet
from list_tpu.infer.pipeline import test_all as j_run_test_all
from list_tpu.train import checkpoints as j_checkpoints
from list_tpu.train.trainer import build_executor as j_build_executor
from list_tpu.train.trainer import build_model as j_build_model
from list_tpu_torch import registry
from list_tpu_torch.bridge import load_flax_variables
from list_tpu_torch.config import default_config
from list_tpu_torch.infer.pipeline import test_all as run_test_all
from list_tpu_torch.models import LIST
from list_tpu_torch.train import LISTExecutor
from list_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
from list_tpu_torch.utils import flax_msgpack

N_SHAPES = 2


def _cfg(default_config, root, data_root, pkg, **kw):
    base = dict(
        image_dir=os.path.join(data_root, 'images') + '/',
        h5_dir=os.path.join(data_root, 'sampled_points') + '/',
        mesh_dir=os.path.join(data_root, 'mesh') + '/',
        split_dir=os.path.join(data_root, 'split'),
        testlist_file=os.path.join(data_root, 'split', 'testlist_all.lst'),
        output_dir=os.path.join(root, pkg) + '/', exp_name='sweep',
        model='network.models.LIST', dataset='datasets.Datasets.IM2SDF',
        catlist=['03001627'], viewnum=2, img_res=32, vox_res=16,
        point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
        im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
        test_pointnum=1024, test_cam_id=0, eval_pred=True)
    base.update(kw)
    return default_config(**base)


@pytest.fixture(scope='module')
def sweep(tmp_path_factory):
    """A 2-shape synthetic tree, a JAX-package checkpoint of the tiny LIST
    (fc_out's bias shifted so the first test image's grid has its median
    at zero) in both packages' checkpoint directories, and each package's
    sweep CSV from it (default --fetch_mode band and bf16 wire, one eval
    worker, np.random seeded before each sweep)."""
    root = str(tmp_path_factory.mktemp('sweep'))
    data_root = os.path.join(root, 'shapenet')
    generate_synthetic_shapenet(data_root, cats=('03001627',),
                                n_shapes=N_SHAPES, n_views=2, img_res=32,
                                n_surface=1200)
    jcfg = _cfg(j_default_config, root, data_root, 'jax')
    tcfg = _cfg(default_config, root, data_root, 'torch')
    jex = j_build_executor(jcfg, j_build_model(jcfg))
    from list_tpu.data import IM2SDF as JIM2SDF
    img = JIM2SDF(jcfg, 'test').get_testdata('03001627', 'synth0000',
                                             0)['rgb_image']
    jex.init_state({'rgb_image': img})
    params = jax.tree.map(np.asarray, jex.state.params)
    # the median from the port's grid (the bridged weights), which spares
    # a compile of the JAX package's predict
    tm = load_flax_variables(LIST.from_config(tcfg), {
        'params': params,
        'batch_stats': jax.tree.map(np.asarray, jex.state.batch_stats)})
    med = float(np.median(LISTExecutor(tcfg, tm, device='cpu').predict_grid(
        img, fetch_mode='grid')))
    params['sdf_decoder']['fc_out']['bias'] = (
        params['sdf_decoder']['fc_out']['bias'] - med * jcfg.sdf_scale)
    jex.state = jex.state.replace(params=params)
    ckpt = os.path.join(jcfg.checkpoint_dir, jcfg.test_checkpoint)
    j_checkpoints.save_checkpoint(0, jex.state, 0.5, ckpt, include_opt=False)
    os.makedirs(tcfg.checkpoint_dir)
    shutil.copy(ckpt, os.path.join(tcfg.checkpoint_dir,
                                   tcfg.test_checkpoint))

    mp = pytest.MonkeyPatch()
    mp.setenv('LIST_TPU_EVAL_WORKERS', '1')
    mp.setenv('LIST_TPU_NATIVE_THREADS', '2')
    try:
        np.random.seed(0)
        jcsv = j_run_test_all(jcfg)
        np.random.seed(0)
        tcsv = run_test_all(tcfg, device='cpu')
    finally:
        mp.undo()
    return dict(root=root, data_root=data_root, jex=jex, tcfg=tcfg,
                jcsv=jcsv, tcsv=tcsv)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_same_scores(got, ref, rtol, atol):
    (gh, grows), (rh, rrows) = _read_csv(got), _read_csv(ref)
    assert gh == rh and 'iou' in gh
    assert len(grows) == len(rrows) == N_SHAPES + 1
    for g, r in zip(grows, rrows):
        assert g[:2] == r[:2]  # index and ID ('Mean' last)
        a = np.asarray(g[2:], np.float64)
        b = np.asarray(r[2:], np.float64)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_sweep_matches_the_jax_package(sweep):
    """Same CSV rows and columns as the JAX package's sweep from the same
    .ckpt, metrics within rtol 7e-2 / atol 2e-2: bf16 compute rounds at
    other places in the two packages (the grids agree to atol 5e-4 /
    rtol 2e-2, tests/test_torch_slice.py), which moves marching-cubes
    vertices of these noisy random-weight surfaces; the metrics' own
    sampling is seeded alike.  Measured: distances within 3.4%, F-scores,
    precisions and recalls within 6.7%, IoU (0.05-0.13 here) within 0.011
    absolute."""
    _assert_same_scores(sweep['tcsv'], sweep['jcsv'], 7e-2, 2e-2)


def test_sweep_infer_batch_over_cached_and_fresh_meshes(sweep,
                                                        monkeypatch):
    """A second sweep with --infer_batch 2 after deleting the mesh of
    shape 1: the group (0, 1) mixes a cached and a fresh mesh, and only the
    fresh one is encoded (the two-image encode is
    tests/test_torch_slice.py::test_predict_grid_batch_matches).  Same CSV as the first sweep within
    rtol 1e-2 / atol 1e-4: the cached meshes are re-read from their .obj
    files (the metrics then sample a re-read mesh, which can shift the
    seeded draws of the shapes after it), and the batch-2 encode sums the
    ResNets' convolutions in another order on the CPU (features within
    5e-7, grids within 8e-6), which moves a few vertices of the fresh
    meshes; metrics measured within 0.67% over 4 shapes; the CSV rounds to
    1e-5."""
    tcfg = sweep['tcfg']
    out = os.path.dirname(sweep['tcsv'])
    first = os.path.join(sweep['root'], 'first.csv')
    shutil.copy(sweep['tcsv'], first)
    for i in (1,):
        os.remove(os.path.join(out, '03001627', f'synth{i:04d}',
                               '00_pred.obj'))
    monkeypatch.setenv('LIST_TPU_EVAL_WORKERS', '1')
    monkeypatch.setenv('LIST_TPU_NATIVE_THREADS', '2')
    calls = []
    real = LISTExecutor.predict_grid_batch

    def spy(self, imgs, *a, **kw):
        calls.append(len(imgs))
        return real(self, imgs, *a, **kw)

    monkeypatch.setattr(LISTExecutor, 'predict_grid_batch', spy)
    tcfg.infer_batch = 2
    try:
        np.random.seed(0)
        csv2 = run_test_all(tcfg, device='cpu')
    finally:
        tcfg.infer_batch = 1
    assert calls == [1]
    _assert_same_scores(csv2, first, 1e-2, 1e-4)


def test_checkpoint_readers(sweep):
    """load_checkpoint reads the JAX package's .ckpt (the weights the
    bridge gives) and the port's own torch-format file (told apart by
    content: the torch file is saved under a .ckpt name)."""
    tcfg = sweep['tcfg']
    ckpt = os.path.join(tcfg.checkpoint_dir, tcfg.test_checkpoint)
    a = LIST.from_config(tcfg)
    assert load_checkpoint(ckpt, a) == (1, 0.5)
    b = load_flax_variables(LIST.from_config(tcfg), {
        'params': jax.tree.map(np.asarray, sweep['jex'].state.params),
        'batch_stats': jax.tree.map(np.asarray,
                                    sweep['jex'].state.batch_stats)})
    for k, v in b.state_dict().items():
        torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)
    path = os.path.join(sweep['root'], 'port.ckpt')
    save_checkpoint(4, a, 0.25, path, step=7)
    c = LIST.from_config(tcfg)
    assert load_checkpoint(path, c) == (5, 0.25)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(c.state_dict()[k], v, rtol=0, atol=0)


def test_checkpoint_step_is_restored_from_both_formats(sweep):
    """The saved optimizer step reads back from the JAX package's .ckpt
    (list_tpu's save_checkpoint of a state at step 7; list_tpu's
    load_checkpoint restores the same 7) and from the port's torch
    format; without ``with_step`` the callers keep (epoch, bestloss)."""
    tcfg, jstate = sweep['tcfg'], sweep['jex'].state.replace(step=7)
    jpath = os.path.join(sweep['root'], 'step7.ckpt')
    j_checkpoints.save_checkpoint(2, jstate, 0.75, jpath, include_opt=False)
    assert j_checkpoints.load_checkpoint(jpath, sweep['jex'].state,
                                         restore_opt=False)[1].step == 7
    m = LIST.from_config(tcfg)
    assert load_checkpoint(jpath, m, with_step=True) == (3, 0.75, 7)
    tpath = os.path.join(sweep['root'], 'step7_port.ckpt')
    save_checkpoint(2, m, 0.75, tpath, step=7)
    assert load_checkpoint(tpath, LIST.from_config(tcfg),
                           with_step=True) == (3, 0.75, 7)
    assert load_checkpoint(tpath, LIST.from_config(tcfg)) == (3, 0.75)


def _same_tree(got, ref):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref)
        for k in ref:
            _same_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same_tree(g, r)
    elif isinstance(ref, np.ndarray) and ref.dtype.name == 'bfloat16':
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref


def test_msgpack_reader_matches_flax(sweep, monkeypatch):
    """The stdlib msgpack reader gives flax.serialization.msgpack_restore's
    tree, values and dtypes on a checkpoint of list_tpu's save_checkpoint
    (optimizer included), with MAX_CHUNK_SIZE patched to 4 MB so the large
    ResNet kernels are written as chunked arrays; and on a small tree of
    the other leaf types (numpy scalars, bfloat16, bool, nil, negative and
    64-bit ints, str, bin)."""
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 1 << 22)
    path = os.path.join(sweep['root'], 'chunked.ckpt')
    j_checkpoints.save_checkpoint(2, sweep['jex'].state, 0.75, path)
    with open(path, 'rb') as f:
        blob = f.read()
    assert b'__msgpack_chunked_array__' in blob
    _same_tree(flax_msgpack.msgpack_restore(blob),
               flax.serialization.msgpack_restore(blob))
    import jax.numpy as jnp
    small = {'s': np.float32(2.5), 'i': np.int64(-3), 'b': b'\x00\xff',
             'bf': np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)),
             'l': [1, -40, 300, -70000, 2 ** 40, True, None, 'x', 0.5],
             'e': np.zeros((0, 3), np.int32)}
    blob = flax.serialization.msgpack_serialize(small)
    _same_tree(flax_msgpack.msgpack_restore(blob),
               flax.serialization.msgpack_restore(blob))


def test_registry_resolves_every_reference_path_to_the_port():
    """Every alias of the JAX package's registry names the same class path
    under list_tpu_torch, and every one imports the port's class."""
    ported = {'LIST', 'IM2SDF', 'SyntheticSDFDataset', 'LISTExecutor',
              'CoarseNet', 'CoarseNetExecutor', 'IM2PointFarthest', 'Pix3D'}
    for name, target in j_registry._ALIASES.items():
        got = registry.resolve(name)
        assert got == 'list_tpu_torch' + target[len('list_tpu'):]
        assert got.rsplit('.', 1)[1] in ported
        assert registry.get_class(name).__module__.startswith(
            'list_tpu_torch.')
    assert registry.executor_for('network.models.LIST') == \
        'list_tpu_torch.train.executors.LISTExecutor'
