"""DISN in the port (``models/disn.py``, ``models/vgg.py``,
``ops/dense_grid.py`` ``disn_grid_sdf``, ``DISNExecutor``) against the
benchmark's plain reference (``benchmark/reference/models/DISN.py``) on
seeded random weights, on the CPU at tiny sizes: images 32^2, narrow
channels, a few hundred queries, a 16^3 grid.

Every tolerance is tight enough that the same computation on bfloat16
operands fails it (each test shows that where its path has a bfloat16
form); the f32 comparisons differ by summation order alone.  Also here:
LIST's dense decode is bit for bit the same through the perceptual block
that both decodes share, and the configuration's camera maps the
shapes' surface points into the render's silhouette.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import program, traffic_gen
from benchmark.reference import model as ref_model
from benchmark.reference import weights
from benchmark.reference.models import DISN as ref
from list_tpu_torch.config import default_config
from list_tpu_torch.models.disn import DISN
from list_tpu_torch.ops import dense_grid
from list_tpu_torch.ops.band import fetch_grid_f32
from list_tpu_torch.ops.dense_grid import disn_grid_sdf
from list_tpu_torch.train.executors import DISNExecutor
from list_tpu_torch.utils.meshing import generate_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 20
TINY = dict(img_res=32, vox_res=16, vgg_widths=[4, 8, 8, 16, 16],
            vgg_fc=[32, 32, 24], disn_point=[8, 16, 32], disn_head=[32, 16],
            train_batch_size=2, sample_point_density=96, weight_decay=0.0)
# f32 against f32: a few hundred terms a sum, so a few f32 round-offs of
# the output's scale; bfloat16 operands (8 bits) read 1e-3 and more
F32_TOL = 1e-4


def _cfg():
    with open(os.path.join(REPO, 'benchmark', 'configs',
                           'disn_shapenet.json')) as f:
        cfg = json.load(f)
    return dict(cfg, **TINY, program_flags=dict(cfg['program_flags'],
                                                 **TINY))


@pytest.fixture(scope='module')
def case():
    """A tiny configuration, its weights, four renders and their shapes."""
    torch.set_num_threads(1)
    cfg = _cfg()
    w = weights.make(ref.spec(cfg), SEED, 'cpu')
    imgs, shapes = traffic_gen.images(cfg, 4, SEED, 'cpu')
    return cfg, w, imgs, shapes


def _model(cfg, w, dtype=torch.float32):
    m = DISN.from_config(program.config(cfg))
    m.load_state_dict(w, strict=True)
    return m.to(dtype).eval()


def _gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def test_per_query_sdf_matches_the_reference(case):
    cfg, w, imgs, shapes = case
    g = torch.Generator().manual_seed(1)
    q = torch.rand(1, 300, 3, generator=g) - 0.5
    img = torch.as_tensor(imgs[:1])
    with ref_model.precision('f32'), torch.no_grad():
        want = ref.decode(w, cfg, q, ref.encode(w, cfg, img))
        got = _model(cfg, w)(img, q)
        low = _model(cfg, w, torch.bfloat16)(img.bfloat16(), q.bfloat16())
    assert _gap(got, want) < F32_TOL
    assert _gap(low, want) > F32_TOL


def test_dense_decode_matches_the_per_query_reference(case):
    """The 16^3 grid in two x slabs against the reference's per-query
    decode of the same grid points."""
    cfg, w, imgs, _ = case
    img = torch.as_tensor(imgs[1:2])
    m = _model(cfg, w)
    with torch.no_grad():
        enc = m.encode(img)
        got = disn_grid_sdf(m, enc, 16, 8, torch.float32)
        low = disn_grid_sdf(m, enc, 16, 8, torch.bfloat16)
    with ref_model.precision('f32'):
        want = ref.sdf_grid(w, cfg, img, 16)
    assert got.shape == (16, 16, 16) and got.dtype == torch.float32
    assert _gap(got, want) < F32_TOL
    assert _gap(low, want) > F32_TOL


def test_train_step_loss_and_every_gradient_match_the_reference(case):
    """One ``DISNExecutor.train`` step in float64 (the first gradient from
    Adam's first moment) against the reference's loss and gradients in
    float64: agreement to 1e-9 of each leaf's scale (float64 round-offs);
    the loss on bfloat16 operands reads 1e-3 off."""
    cfg, w, _, _ = case
    batch = ref.batches(cfg, {'distinct_batches': 1}, SEED, 'cpu')[0]
    m = _model(cfg, w, torch.float64)
    ex = DISNExecutor(program.config(cfg), m, device='cpu')
    _, losses = ex.train(batch)
    beta1 = cfg['beta1']
    got = {k: ex.optimizer.state[p]['exp_avg'] / (1 - beta1)
           for k, p in m.named_parameters()}
    P = {k: v.double().requires_grad_() for k, v in w.items()}
    dev = {k: torch.as_tensor(v).double() for k, v in batch.items()}
    want = ref.losses(P, cfg, dev)
    assert set(got) == set(P)
    assert abs(float(losses['sdf_loss']) - float(want['sdf_loss'])) \
        < 1e-9 * float(want['sdf_loss'])
    for k, p in P.items():
        scale = float(p.grad.abs().max())
        assert float((got[k] - p.grad).abs().max()) <= 1e-9 * scale, k
    lm = _model(cfg, w, torch.bfloat16)
    with torch.no_grad():
        low = ref.weighted_l1(lm(dev['rgb_image'].bfloat16(),
                                 dev['points'].bfloat16(),
                                 dev['trans_mat'].bfloat16()).double(),
                              dev['values'], cfg)
    assert abs(float(low) - float(want['sdf_loss'])) \
        > 1e-9 * float(want['sdf_loss'])


def test_predict_grid_takes_the_band_wire_to_a_mesh(case):
    """The production path on the CPU (bfloat16 decode, bfloat16 band
    wire) with the output layers fitted as the benchmark fits them:
    ``predict_grid(device_out=True)`` -> ``fetch_grid_f32`` -> a mesh.
    The wire's band cells are the bfloat16 grid's exactly; the classes
    flip on under 15% of the reference's band cells (the cell's limit)."""
    cfg, w, imgs, shapes = case
    w = {k: v.clone() for k, v in w.items()}
    ref.prepare_mesh(cfg, {'fit_images': 2}, w, imgs, shapes, SEED, 'cpu',
                     lambda _: None)
    ex = program.executor(cfg, w, 'cpu')
    res = ex.predict_grid(imgs[:1], device_out=True)
    grid = fetch_grid_f32(res)
    whole = ex.predict_grid(imgs[:1], fetch_mode='grid')
    band = np.abs(grid) != 1.0
    assert band.any() and np.array_equal(grid[band], whole[band])
    verts, faces = generate_mesh(grid, cfg['bb_min'], cfg['bb_max'])
    assert len(verts) > 0 and len(faces) > 0
    with ref_model.precision('f32'):
        want = (ref.sdf_grid(w, cfg, torch.as_tensor(imgs[:1]), 16)
                / cfg['sdf_scale']).numpy()
    from benchmark import check
    r = check.mesh_readings(grid, verts, want, cfg['bb_min'], cfg['bb_max'])
    assert r['class_flip'] < 0.15, r


def _argv(d):
    out = []
    for k, v in d.items():
        out += [f'--{k}'] + ([str(x) for x in v] if isinstance(v, list)
                             else [str(v)])
    return out


def test_train_and_infer_drivers_run_disn_by_name(tmp_path):
    """``train_torch.py`` (one epoch of the synthetic set) and
    ``infer_torch.py`` (two shapes of its sweep) with ``--model DISN``."""
    import infer_torch
    import train_torch
    torch.set_num_threads(1)
    flags = dict(TINY, model='DISN', dataset='Synthetic', exp_name='disn',
                 output_dir=str(tmp_path) + '/', testlist_file='',
                 epochs=1, test_every_epoch=100, save_every_epoch=100,
                 num_workers=1, sdf_scale=10.0, chunk_l=1,
                 sample_distribution=[0.5, 0.5], sigmas=[0.01, 0.07])
    train_torch.main(_argv(flags) + ['--device', 'cpu'])
    c = default_config(**{k: v for k, v in flags.items()})
    assert os.path.exists(os.path.join(c.checkpoint_dir,
                                       'best_model_train.ckpt'))
    infer_torch.main(_argv(dict(flags, test_checkpoint='best_model_train.ckpt'))
                     + ['--device', 'cpu'])
    objs = [f for _, _, fs in os.walk(c.results_dir) for f in fs
            if f.endswith('_pred.obj')]
    assert len(objs) == 2


def _old_percep(feat_l2, w1_percep, dt, t, p0, p1, p2):
    """The perceptual block as LIST's dense decode wrote it inline before
    it was shared: the maps' projection, then one slab's sample."""
    ms = dense_grid.PERCEP_MAP
    pmaps = torch.cat([dense_grid.resize_bilinear_align_corners(f, ms, ms)
                       for f in feat_l2], dim=-1)
    pm512 = dense_grid._mm32(pmaps.to(dt), w1_percep.to(dt)).to(dt)
    flat_pm = pm512[0].reshape(ms * ms, -1)
    n = p0.numel()
    u = p0 * t[0, 0] + p1 * t[1, 0] + p2 * t[2, 0] + t[3, 0]
    v = p0 * t[0, 1] + p1 * t[1, 1] + p2 * t[2, 1] + t[3, 1]
    d = p0 * t[0, 2] + p1 * t[1, 2] + p2 * t[2, 2] + t[3, 2]
    xpix = (u / (d + 1e-8)).clamp(0.0, float(ms - 1))
    ypix = (v / (d + 1e-8)).clamp(0.0, float(ms - 1))
    x0i = torch.floor(xpix).long()
    y0i = torch.floor(ypix).long()
    x1i = (x0i + 1).clamp(max=ms - 1)
    y1i = (y0i + 1).clamp(max=ms - 1)
    wxf = (xpix - x0i.float()).reshape(n, 1).to(dt)
    wyf = (ypix - y0i.float()).reshape(n, 1).to(dt)
    idx = torch.cat([(y0i * ms + x0i).reshape(n),
                     (y0i * ms + x1i).reshape(n),
                     (y1i * ms + x0i).reshape(n),
                     (y1i * ms + x1i).reshape(n)])
    vals = flat_pm[idx].reshape(4, n, -1)
    top = vals[0] * (1 - wxf) + vals[1] * wxf
    bot = vals[2] * (1 - wxf) + vals[3] * wxf
    return top * (1 - wyf) + bot * wyf


@pytest.mark.parametrize('dt', [torch.bfloat16, torch.float32])
def test_list_percep_block_is_bit_for_bit_the_inline_one(dt):
    """LIST's dense decode calls ``percep_maps`` and ``percep_sample``
    where its slab loop computed them inline; on a LIST-shaped pyramid
    (1,024 channels at 112^2 .. 7^2) and a learned camera the two give
    the same bits."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(7)
    feats = [torch.randn(1, r, r, c, generator=g)
             for r, c in ((112, 64), (56, 64), (28, 128), (14, 256),
                          (7, 512))]
    w1 = torch.randn(1024, 64, generator=g) * 0.05
    t = torch.tensor([[60.0, 1.0, 0.1], [2.0, -60.0, 0.05],
                      [0.5, 0.3, 0.02], [68.0, 68.0, 1.0]])
    ar = torch.linspace(-0.5, 0.5, 8)
    fx, fy, fz = (ar[:4, None, None].expand(4, 8, 8),
                  ar[None, :, None].expand(4, 8, 8),
                  ar[None, None, :].expand(4, 8, 8))
    p0, p1, p2 = 2.0 * fz, 2.0 * fy, 2.0 * fx
    new = dense_grid.percep_sample(dense_grid.percep_maps(feats, w1, dt), t,
                                   p0, p1, p2, dt)
    old = _old_percep(feats, w1, dt, t, p0, p1, p2)
    assert new.dtype == dt and torch.equal(new, old)


def _silhouette(shapes, res):
    """(S, res, res): the pixels whose ray hits the shape, by the renders'
    own march (``traffic_gen.Shapes.render``)."""
    u = torch.linspace(-0.6, 0.6, res)
    py, px = torch.meshgrid(-u, u, indexing='ij')
    px, py = px.expand(shapes.n, -1, -1), py.expand(shapes.n, -1, -1)
    hit = torch.zeros_like(px, dtype=torch.bool)
    t = torch.full_like(px, -0.7)
    for _ in range(48):
        d = shapes.sdf(torch.stack([px, py, t], -1))
        hit |= d < 1e-3
        t = t + d.clamp(1e-3, 0.1) * ~hit
    return hit


def test_the_configured_camera_maps_surface_points_into_the_silhouette():
    """``disn_camera`` (the configuration's and the program's default)
    sends points on the synthetic shapes' surfaces to pixels of their
    137^2 renders inside the silhouette, up to the one pixel of the
    silhouette's rounding; the camera mirrored in y does not."""
    cfg = _cfg()
    assert default_config(model='DISN').disn_camera == pytest.approx(
        cfg['disn_camera'])
    torch.set_num_threads(1)
    rng, g = traffic_gen._gens(SEED, 'camera', 'cpu')
    shapes = traffic_gen.Shapes(rng, 4, 'cpu')
    res = 137
    grown = torch.nn.functional.max_pool2d(
        _silhouette(shapes, res)[:, None].float(), 3, 1, 1)[:, 0] > 0
    pts = shapes.surface(500, g)
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)

    def share_inside(cam):
        uvd = homo @ cam.view(4, 3)
        u = (uvd[..., 0] / uvd[..., 2]).round().long().clamp(0, res - 1)
        v = (uvd[..., 1] / uvd[..., 2]).round().long().clamp(0, res - 1)
        return float(grown[torch.arange(4)[:, None], v, u].float().mean())

    cam = torch.tensor(cfg['disn_camera'])
    assert share_inside(cam) == 1.0
    mirrored = cam.clone()
    mirrored[4] = -mirrored[4]
    mirrored[10] = 136.0 - mirrored[10]
    assert share_inside(mirrored) < 0.9
