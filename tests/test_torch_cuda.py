"""CUDA kernels of the port against their plain PyTorch versions, the
farthest-point sampling on the card against the CPU, and the sweep's
overlapped device_out fetch.  They skip where
torch has no CUDA device.  This file imports no JAX so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from list_tpu_torch.ops.cuda import fused_fc0, stencil3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is False')
    return torch.device('cuda')


# (ci, co, dhw, batch): every Ci x Co of {1, 3, 16} x {1, 5, 12, 16} (Co
# padded to 1, 8, 12, 16: tiles of 32, 16, 8, 8 rows), H ragged against
# the tile's rows, W ragged against the 128-wide tile and the four voxels a
# lane (33, 40, 127, 17), a full tile (128) and a second tile (130), the
# 16 -> 1 dx shape, and B * D = 65,664 (above the 65,535 of a grid axis)
CONV_CASES = [(1, 1, (5, 7, 33), 2), (1, 16, (4, 9, 40), 2),
              (16, 16, (3, 8, 128), 2), (3, 5, (4, 8, 17), 2),
              (1, 5, (3, 17, 127), 2), (1, 12, (2, 33, 128), 2),
              (3, 1, (3, 31, 130), 2), (3, 12, (2, 9, 40), 2),
              (3, 16, (3, 10, 127), 2), (16, 1, (3, 33, 128), 2),
              (16, 5, (2, 19, 33), 2), (16, 12, (2, 9, 130), 2),
              (1, 1, (128, 2, 5), 513)]


@pytest.mark.parametrize('ci,co,dhw,batch', CONV_CASES)
def test_conv3x3x3_kernel_matches_plain(cuda, ci, co, dhw, batch):
    """f32 FMAs on both sides, sums in another order: atol = rtol = 1e-4."""
    g = torch.Generator(device='cpu').manual_seed(ci * 31 + co)
    x = torch.randn(batch, ci, *dhw, generator=g).to(cuda)
    w = (torch.randn(co, ci, 3, 3, 3, generator=g) * 0.2).to(cuda)
    before = stencil3d.launches
    got = stencil3d.conv3x3x3(x, w)
    torch.cuda.synchronize()
    assert stencil3d.launches == before + 1
    ref = stencil3d.conv3x3x3_plain(x, w)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


# (ci, co, dhw, blocks): every Ci x Co of {1, 3, 16} x {1, 5, 12, 16} (one
# or two 8-channel blocks; Co padded to 1, 8, 12, 16), odd H against the
# 2-row step, W ragged against the 128-wide tile (33, 40, 127), a full tile
# (128) and a second tile (130); ``blocks`` overrides DK_BLOCKS so a block
# walks z-runs that start and end inside a column and cross into the next
# (default: at most one row a block here, some blocks with none)
DK_CASES = [(1, 1, (5, 7, 33), None), (1, 16, (4, 9, 40), None),
            (16, 16, (3, 8, 128), None), (16, 1, (3, 5, 9), None),
            (3, 5, (4, 8, 17), None), (1, 1, (7, 3, 127), 5),
            (1, 5, (6, 5, 130), 7), (1, 12, (5, 3, 128), 4),
            (3, 1, (9, 2, 40), 3), (3, 12, (4, 5, 33), None),
            (3, 16, (6, 3, 127), 5), (16, 5, (5, 3, 130), 3),
            (16, 12, (3, 4, 40), None), (16, 16, (11, 3, 127), 4)]


@pytest.mark.parametrize('ci,co,dhw,blocks', DK_CASES)
def test_conv3x3x3_dk_kernel_matches_plain(cuda, monkeypatch, ci, co, dhw,
                                           blocks):
    """K3 against conv3x3x3_dk_plain: f32 FMAs on both sides, sums of
    B*D*H*W products in another order: |K3 - plain| <= 1e-4 * max|plain|.
    Its reduction is deterministic: two runs give bit-identical dk."""
    if blocks is not None:
        monkeypatch.setattr(stencil3d, 'DK_BLOCKS', blocks)
    g_ = torch.Generator(device='cpu').manual_seed(ci * 13 + co)
    x = torch.rand(2, ci, *dhw, generator=g_).to(cuda)
    g = torch.randn(2, co, *dhw, generator=g_).to(cuda)
    before = stencil3d.dk_launches
    got = stencil3d.conv3x3x3_dk(x, g)
    torch.cuda.synchronize()
    assert stencil3d.dk_launches == before + 1
    ref = stencil3d.conv3x3x3_dk_plain(x, g)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(stencil3d.conv3x3x3_dk(x, g), got)


@pytest.mark.parametrize('ci,co', [(16, 16), (1, 16), (16, 1)])
def test_conv3x3x3_gradients_on_the_card(cuda, ci, co):
    """Conv3x3x3Fn on CUDA tensors carries a grad_fn; its dx (K2 on
    flipped, transposed weights) and dk (K3) agree with autograd through
    the plain version within 1e-4 * max|plain|, and the backward launches
    one K2 (dx) and one K3."""
    g_ = torch.Generator(device='cpu').manual_seed(ci + 7 * co)
    x0 = torch.randn(2, ci, 4, 8, 33, generator=g_)
    w0 = torch.randn(co, ci, 3, 3, 3, generator=g_) * 0.2
    r = torch.randn(2, co, 4, 8, 33, generator=g_).to(cuda)
    x = x0.to(cuda).requires_grad_()
    w = w0.to(cuda).requires_grad_()
    before = (stencil3d.launches, stencil3d.dx_launches,
              stencil3d.dk_launches)
    y = stencil3d.conv3x3x3(x, w)
    assert y.grad_fn is not None
    (y * r).sum().backward()
    torch.cuda.synchronize()
    assert (stencil3d.launches, stencil3d.dx_launches,
            stencil3d.dk_launches) == (before[0] + 2, before[1] + 1,
                                       before[2] + 1)
    xp = x0.to(cuda).requires_grad_()
    wp = w0.to(cuda).requires_grad_()
    (stencil3d.conv3x3x3_plain(xp, wp) * r).sum().backward()
    for got, ref in ((x.grad, xp.grad), (w.grad, wp.grad)):
        assert float((got - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max())


K1_KS = (85, 17, 17, 160, 32, 32, 320, 64, 64)  # the production parts


def _head_args(n, coarse, dev, seed=0, Ks=K1_KS, offset=0):
    """K1's arguments; ``offset`` > 0 starts each part that many bf16
    elements into its buffer, so no part's rows are 16-byte aligned."""
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    parts = []
    for K in Ks:
        buf = torch.empty(n * K + offset, dtype=bf, device=dev)
        parts.append(buf[offset:].view(n, K).copy_(t(rng.rand(n, K), bf)))
    w1 = [t(rng.uniform(-1, 1, (K, 512)) / np.sqrt(sum(Ks)), bf) for K in Ks]
    c = None if coarse is None else t(rng.randn(n, 512),
                                      bf if coarse == 'bf16'
                                      else torch.float32)
    return (parts, c, t(rng.randn(n, 512), bf),
            t(rng.uniform(-1, 1, (n, 3))), w1,
            t(rng.randn(3, 512) * 0.3), t(rng.randn(512) * 0.1),
            t(rng.uniform(-1, 1, (512, 256)) / np.sqrt(512), bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 256)) / 16.0, bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 1)) / 16.0, bf), t(rng.randn(1)))


# (Ks, offset): the production parts; one part (padded width 32); padded
# widths 288 and 144 (144 is not a multiple of a 32-row ring slice, so the
# last slice of each W1 half is short; K = 8 pads a zero 16-byte chunk);
# the production parts with no 16-byte aligned part (all staged 2 bytes at
# a time)
HEAD_PARTS = [(K1_KS, 0), ((17,), 0), ((85, 17, 160), 0), ((85, 17, 8), 0),
              (K1_KS, 1)]


@pytest.mark.parametrize('Ks,offset', HEAD_PARTS,
                         ids=['prod', '17', '85-17-160', '85-17-8',
                              'prod-unaligned'])
@pytest.mark.parametrize('n', [64, 1000, 64 * 150 + 37])
@pytest.mark.parametrize('coarse', [None, 'bf16', 'f32'])
def test_fused_stack_head_kernel_matches_plain(cuda, n, coarse, Ks, offset):
    """bf16 operands, f32 accumulation on both sides; the ReLU outputs are
    recast to bf16, where a different f32 sum order can flip one rounding
    step (2^-8 relative): |kernel - plain| <= 1e-2 + 1e-2 |plain|.  n spans
    one tile, a ragged 16 and 151 tiles with a ragged tail of 37."""
    args = _head_args(n, coarse, cuda, Ks=Ks, offset=offset)
    before = fused_fc0.launches
    got = fused_fc0.fused_stack_head(*args)
    torch.cuda.synchronize()
    assert fused_fc0.launches == before + 1
    ref = fused_fc0.fused_stack_head_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)


def _mlp_args(n, channels, dev, seed=0, offset=0):
    """K4's arguments; ``offset`` > 0 starts each stack that many bf16
    elements into its buffer, so no stack's base is 16-byte aligned."""
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    rows = 7 * sum(channels)
    stacks = []
    for c in channels:
        buf = torch.empty(7 * n * c + offset, dtype=bf, device=dev)
        stacks.append(buf[offset:].view(7, n, c).copy_(t(rng.rand(7, n, c),
                                                         bf)))
    w1 = [t(rng.uniform(-1, 1, (7 * c, 512)) / np.sqrt(rows), bf)
          for c in channels]
    return (stacks, t(rng.randn(n, 512), bf), t(rng.uniform(-1, 1, (n, 3))),
            w1, t(rng.randn(3, 512) * 0.3), t(rng.randn(512) * 0.1),
            t(rng.uniform(-1, 1, (512, 256)) / np.sqrt(512), bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 256)) / 16.0, bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 1)) / 16.0, bf), t(rng.randn(1)))


K4_CS = (1, 16, 32, 64)  # the production scales
K4_VEC = ('taps', 'rows', 'rows', 'rows')
# (n, channels, offset, the staging path of each scale): the production
# scales at one tile, a ragged 16 tiles, 128 tiles, and K1's 151 tiles
# with a ragged tail of 37 and n = 1,003 (n % 8 != 0: the C = 1 scale
# scalar); C = 1 alone; odd channels; C = 8 (a 16-byte zero chunk pads
# 56 columns to 64) beside C = 24 (C / 8 not a power of two: scalar); and
# the production scales one bf16 into their buffers (every scale scalar)
MLP_CASES = [
    (64, K4_CS, 0, K4_VEC), (1000, K4_CS, 0, K4_VEC),
    (8192, K4_CS, 0, K4_VEC),
    (64 * 150 + 37, K4_CS, 0, ('scalar',) + K4_VEC[1:]),
    (1003, K4_CS, 0, ('scalar',) + K4_VEC[1:]),
    (64, (1,), 0, ('taps',)), (1000, (1,), 0, ('taps',)),
    (64, (3, 5), 0, ('scalar',) * 2), (1000, (3, 5), 0, ('scalar',) * 2),
    (1000, (8, 24), 0, ('rows', 'scalar')),
    (1000, K4_CS, 1, ('scalar',) * 4),
    (64 * 150 + 37, K4_CS, 1, ('scalar',) * 4)]


@pytest.mark.parametrize(
    'n,channels,offset,staging', MLP_CASES,
    ids=[f'{n}-{"-".join(map(str, cs))}' + ('-unaligned' if o else '')
         for n, cs, o, _ in MLP_CASES])
def test_fused_fc0_mlp_kernel_matches_plain(cuda, n, channels, offset,
                                            staging):
    """K4 against fused_fc0_mlp_plain: bf16 operands, f32 accumulation on
    both sides, the C = 1 scale's products exact on both; a different f32
    sum order can flip one bf16 rounding of a ReLU output (2^-8 relative):
    |kernel - plain| <= 1e-2 + 1e-2 |plain|.  The launch reports the
    staging path it took for each scale."""
    args = _mlp_args(n, channels, cuda, offset=offset)
    before = fused_fc0.mlp_launches
    got = fused_fc0.fused_fc0_mlp(*args)
    torch.cuda.synchronize()
    assert fused_fc0.mlp_launches == before + 1
    assert fused_fc0.mlp_staging == staging
    ref = fused_fc0.fused_fc0_mlp_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 1, 4, 4, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        stencil3d.conv3x3x3(x, torch.zeros(1, 1, 3, 3, 3, device=cuda,
                                           dtype=torch.float64))
    with pytest.raises(TypeError):
        stencil3d.conv3x3x3_dk(x, x)
    x = x.float()
    for co, ci in ((17, 1), (16, 29)):  # Co > 16; 50,112 B of weights
        with pytest.raises(ValueError):
            stencil3d.conv3x3x3(x.expand(1, ci, 4, 4, 4).contiguous(),
                                torch.zeros(co, ci, 3, 3, 3, device=cuda))
    with pytest.raises(ValueError):  # Ci > 16
        stencil3d.conv3x3x3_dk(x.expand(1, 17, 4, 4, 4).contiguous(), x)
    args = list(_head_args(64, None, cuda))
    args[0] = [p.float() for p in args[0]]
    with pytest.raises(ValueError):
        fused_fc0.fused_stack_head(*args)
    args = list(_mlp_args(64, (1, 16), cuda))
    args[0] = [s.transpose(0, 1) for s in args[0]]  # (n, 7, C): not t-major
    with pytest.raises(ValueError):
        fused_fc0.fused_fc0_mlp(*args)


@pytest.mark.parametrize('n,k', [(1200, 256), (20000, 2000)])
def test_fps_on_the_card_is_the_cpus(cuda, n, k):
    """The port's farthest-point sampling (plain PyTorch, no kernel of its
    own) picks the same indices on the card as on the CPU: its squared
    distance rounds alike on both (ops/fps.py)."""
    from list_tpu_torch.ops.fps import farthest_point_sampling
    pts = torch.as_tensor(np.random.RandomState(n + k).randn(n, 3),
                          dtype=torch.float32)
    got = farthest_point_sampling(pts.to(cuda), k)
    assert got.device.type == 'cuda'
    torch.testing.assert_close(got.cpu(), farthest_point_sampling(pts, k),
                               rtol=0, atol=0)


# ---- several cards ---------------------------------------------------------

def _need_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f'needs {n} cards, torch sees '
                    f'{torch.cuda.device_count()}')


def test_kernels_launch_on_their_operands_card(cuda):
    """Each kernel on cuda:1 while cuda:0 is the current device: K2's
    forward, its dx and K3 through Conv3x3x3Fn's backward, K3 alone, K1
    and K4 each launch on cuda:1 (counted once a launch), agree with their
    plain versions there (the conv's tolerances as above, the heads' 1e-2
    + 1e-2 |plain|), and leave cuda:0 current."""
    _need_cards(2)
    dev = torch.device('cuda', 1)
    torch.cuda.set_device(0)
    g_ = torch.Generator(device='cpu').manual_seed(21)
    x0 = torch.randn(2, 16, 4, 8, 33, generator=g_)
    w0 = torch.randn(16, 16, 3, 3, 3, generator=g_) * 0.2
    r = torch.randn(2, 16, 4, 8, 33, generator=g_).to(dev)
    x, w = x0.to(dev).requires_grad_(), w0.to(dev).requires_grad_()
    before = (stencil3d.launches, stencil3d.dx_launches,
              stencil3d.dk_launches)
    y = stencil3d.conv3x3x3(x, w)
    (y * r).sum().backward()
    dk = stencil3d.conv3x3x3_dk(x.detach(), r)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert (stencil3d.launches, stencil3d.dx_launches,
            stencil3d.dk_launches) == (before[0] + 2, before[1] + 1,
                                       before[2] + 2)
    xp, wp = x0.to(dev).requires_grad_(), w0.to(dev).requires_grad_()
    yp = stencil3d.conv3x3x3_plain(xp, wp)
    (yp * r).sum().backward()
    assert y.device == x.grad.device == w.grad.device == dk.device == dev
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    for got, ref in ((x.grad, xp.grad), (w.grad, wp.grad), (dk, wp.grad)):
        assert float((got - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max())
    for kernel, plain, args, count in (
            (fused_fc0.fused_stack_head, fused_fc0.fused_stack_head_plain,
             _head_args(1000, 'bf16', dev), 'launches'),
            (fused_fc0.fused_fc0_mlp, fused_fc0.fused_fc0_mlp_plain,
             _mlp_args(1000, K4_CS, dev), 'mlp_launches')):
        before = getattr(fused_fc0, count)
        got = kernel(*args)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        assert getattr(fused_fc0, count) == before + 1
        assert got.device == dev
        torch.testing.assert_close(got, plain(*args), atol=1e-2, rtol=1e-2)


def test_split_decode_over_the_cards_is_the_one_card_grid(cuda):
    """predict_grid under --mesh_shape N (every card) on the full-width
    LIST at 128^3 gives the one-card grid bit for bit (K1 computes each
    query on its own), with one K1 launch a card, and cuda:0 stays
    current."""
    _need_cards(2)
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from list_tpu_torch.train import LISTExecutor
    n = next(k for k in (8, 4, 2) if torch.cuda.device_count() >= k)
    torch.cuda.set_device(0)
    torch.manual_seed(0)
    model = LIST.from_config(default_config(vox_res=128))
    img = np.random.RandomState(0).rand(1, 224, 224, 3).astype(np.float32)
    kw = dict(fetch_dtype='float32', fetch_mode='grid')
    one = LISTExecutor(default_config(vox_res=128, sdf_scale=10.0), model)
    split = LISTExecutor(default_config(vox_res=128, sdf_scale=10.0,
                                        mesh_shape=[n]), model)
    assert split.decode_devices == [torch.device('cuda', i)
                                    for i in range(n)]
    ref = one.predict_grid(img, **kw)
    reset_launch_counts()
    got = split.predict_grid(img, **kw)
    assert launch_counts()['fused_stack_head'] == n
    assert torch.cuda.current_device() == 0
    assert np.isfinite(got).all() and np.array_equal(got, ref)


# ---- the sweep's overlapped fetch ---------------------------------------------

@pytest.fixture(scope='module')
def card_executor():
    """The full-width default LIST at vox_res 128 on the card with seeded
    weights, three seeded 224x224 images, and fc_out bias shifts that
    centre the first image's grid on its median (a surface too large for
    the band: an overflow) and on its 3% quantile (a band that fits)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is False')
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    cfg = default_config(vox_res=128, sdf_scale=10.0)
    torch.manual_seed(0)
    ex = LISTExecutor(cfg, LIST.from_config(cfg))
    rng = np.random.RandomState(0)
    imgs = [rng.rand(1, 224, 224, 3).astype(np.float32) for _ in range(3)]
    grid = ex.predict_grid(imgs[0], fetch_mode='grid')
    bias = ex.model.sdf_decoder.fc_out.bias
    base = bias.detach().clone()
    shifts = {q: float(np.quantile(grid, q)) * cfg.sdf_scale
              for q in (0.5, 0.03)}
    yield ex, imgs, base, shifts
    del ex
    torch.cuda.empty_cache()


@pytest.mark.parametrize('mode', ['band overflow', 'band', 'grid'])
def test_device_out_fetch_overlaps_the_next_shape(cuda, card_executor, mode):
    """The sweep's order: shape i's device_out result is fetched on a
    worker (side stream, waiting on its event) while shape i+1 is already
    queued on the main stream; every fetched grid is bit-identical to the
    synchronized fetch of the same shape (band mode with a band that
    overflows into the full-grid fetch, band mode decoded from the band,
    grid mode; bf16 wire).  The bias shifts are the first image's, so
    each band case asserts that at least one shape took its path."""
    from concurrent.futures import ThreadPoolExecutor
    from list_tpu_torch.ops import band
    ex, imgs, base, shifts = card_executor
    fetch_mode = 'grid' if mode == 'grid' else 'band'
    with torch.no_grad():
        ex.model.sdf_decoder.fc_out.bias.copy_(
            base - shifts[0.5 if mode == 'band overflow' else 0.03])
    want = [ex.predict_grid(img, fetch_mode=fetch_mode) for img in imgs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        outs, futs = [], []
        for img in imgs:
            outs.append(ex.predict_grid(img, fetch_mode=fetch_mode,
                                        device_out=True))
            if len(outs) > 1:  # shape i fetched once shape i+1 is queued
                futs.append(pool.submit(band.fetch_grid_f32, outs[-2]))
        futs.append(pool.submit(band.fetch_grid_f32, outs[-1]))
        got = [f.result() for f in futs]
    if fetch_mode == 'band':  # the path under test was taken
        counts = [int(band.band_to_numpy(o.band)[-1]) for o in outs]
        cap = band.band_cap(128 ** 3)
        assert any((c > cap) == (mode == 'band overflow')
                   for c in counts), (counts, cap)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_device_out_times_match_the_synchronized_phases(cuda, card_executor):
    """encode_s and decode_s of a device_out call (CUDA events, resolved
    by its fetch into ``timings``) agree within 10% with the same phases
    timed on the host clock around synchronized calls: medians of 11
    rounds of each, in turns, after 2 rounds of warm-up (the batch-1
    encode is bound by the host's launches, whose time varies by 10-20%
    from one call to the next)."""
    from list_tpu_torch.ops import band
    ex, imgs, base, shifts = card_executor
    with torch.no_grad():
        ex.model.sdf_decoder.fc_out.bias.copy_(base - shifts[0.03])
    img = torch.as_tensor(imgs[1], device=cuda)
    slab, head = ex._dense_plan()
    synced, events = [], []
    for _ in range(13):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = ex.model.encode(img)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ex._finish(ex._decode(enc, slab, head), 'bfloat16', 'band')
            torch.cuda.synchronize()
            synced.append((t1 - t0, time.perf_counter() - t1))
        out = ex.predict_grid(imgs[1], device_out=True)
        assert 'decode_s' not in ex.timings
        band.fetch_grid_f32(out)
        events.append((ex.timings['encode_s'], ex.timings['decode_s']))
        assert out.spans.resolve() == dict(encode_s=events[-1][0],
                                           decode_s=events[-1][1])
    for i, name in enumerate(('encode_s', 'decode_s')):
        s = float(np.median([t[i] for t in synced[2:]]))
        e = float(np.median([t[i] for t in events[2:]]))
        assert abs(e - s) <= 0.1 * s, (name, e, s)
