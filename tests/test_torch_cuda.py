"""CUDA kernels of the port against their plain PyTorch versions, and the
farthest-point sampling on the card against the CPU.  They skip where
torch has no CUDA device.  This file imports no JAX so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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


def _mlp_args(n, channels, dev, seed=0):
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    rows = 7 * sum(channels)
    stacks = [t(rng.rand(7, n, c), bf) for c in channels]
    w1 = [t(rng.uniform(-1, 1, (7 * c, 512)) / np.sqrt(rows), bf)
          for c in channels]
    return (stacks, t(rng.randn(n, 512), bf), t(rng.uniform(-1, 1, (n, 3))),
            w1, t(rng.randn(3, 512) * 0.3), t(rng.randn(512) * 0.1),
            t(rng.uniform(-1, 1, (512, 256)) / np.sqrt(512), bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 256)) / 16.0, bf),
            t(rng.randn(256) * 0.1),
            t(rng.uniform(-1, 1, (256, 1)) / 16.0, bf), t(rng.randn(1)))


@pytest.mark.parametrize('n', [64, 1000])
@pytest.mark.parametrize('channels', [(1, 16, 32, 64), (1,), (3, 5)])
def test_fused_fc0_mlp_kernel_matches_plain(cuda, n, channels):
    """K4 against fused_fc0_mlp_plain: bf16 operands, f32 accumulation on
    both sides, the C = 1 scale's products exact on both; a different f32
    sum order can flip one bf16 rounding of a ReLU output (2^-8 relative):
    |kernel - plain| <= 1e-2 + 1e-2 |plain|."""
    args = _mlp_args(n, channels, cuda)
    before = fused_fc0.mlp_launches
    got = fused_fc0.fused_fc0_mlp(*args)
    torch.cuda.synchronize()
    assert fused_fc0.mlp_launches == before + 1
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
