"""CUDA kernels of the port against their plain PyTorch versions, the
farthest-point sampling on the card against the CPU, and the sweep's
overlapped device_out fetch.  They skip where
torch has no CUDA device.  This file imports no JAX so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy
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


# (shape, offset): C in {1, 16, 32}; spatial sizes odd (one float a thread)
# and multiples of 4 (float4s); extents ragged against the block's chunk
# (8,192 elements at least), with several blocks a channel whose ranges
# cross batch rows; and an input 4 bytes off 16-byte alignment (no float4)
BN_CASES = [((2, 1, 5, 7, 33), 0), ((2, 1, 63, 65, 67), 0),
            ((3, 16, 33, 32, 32), 0), ((3, 16, 9, 10, 13), 0),
            ((2, 32, 17, 19), 0), ((2, 32, 40, 41, 44), 0),
            ((2, 16, 24, 32, 36), 1)]
U = 2.0 ** -24  # f32 round-off
BN_FWD_U, BN_BWD_U = 16, 64  # the limits, in U * max|plain|


def _ulps(got, ref):
    """max|got - ref| in units of U * max|ref|."""
    return float((got.double() - ref).abs().max() / (U * ref.abs().max()))


def _bn_inputs(shape, dev, seed, offset=0):
    g_ = torch.Generator(device='cpu').manual_seed(seed)
    n = int(np.prod(shape))
    x = torch.empty(n + offset, device=dev)[offset:].view(shape)
    x.copy_(3.0 + torch.randn(shape, generator=g_))
    w = (1.0 + 0.5 * torch.randn(shape[1], generator=g_)).to(dev)
    b = torch.randn(shape[1], generator=g_).to(dev)
    dy = torch.randn(shape, generator=g_).to(dev)
    return x, w, b, dy


@pytest.mark.parametrize('shape,offset', BN_CASES)
def test_batch_norm_kernels_match_plain(cuda, shape, offset):
    """The kernels' statistics (batch mean, biased variance, rstd), their
    normalize with them (the training forward's y), the backward (dx,
    dweight, dbias) and the eval normalize against the plain versions in
    float64 on x = 3 + N(0, 1): within BN_FWD_U (forward) and BN_BWD_U
    (backward) f32 round-offs of max|plain|.  Two calls give bit-identical
    results; an eval call counts one forward launch, a backward one."""
    from list_tpu_torch.ops.cuda import batch_norm as bn
    x, w, b, dy = _bn_inputs(shape, cuda, sum(shape) + offset, offset)
    rm = torch.randn(shape[1], device=cuda)
    rv = torch.rand(shape[1], device=cuda) + 0.5
    before = (bn.launches, bn.bwd_launches)
    runs = []
    for _ in range(2):
        mean, var, rstd = bn._stats(x)
        runs.append((bn._apply(x, mean, rstd, w, b, False), mean, var, rstd)
                    + bn._backward(x, dy, w, mean, rstd, True))
    ye = bn.batch_norm_eval(x, rm, rv, w, b)
    torch.cuda.synchronize()
    assert (bn.launches, bn.bwd_launches) == (before[0] + 1, before[1] + 2)
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    y, mean, var, rstd, dx, dw, db = runs[0]
    x64, w64, b64, dy64 = (t.double() for t in (x, w, b, dy))
    y_ref, mean_ref, var_ref = bn.batch_norm_train_plain(x64, w64, b64)
    rstd_ref = torch.rsqrt(var_ref + bn.EPS)
    dx_ref, dw_ref, db_ref = bn.batch_norm_backward_plain(
        x64, dy64, w64, mean_ref, rstd_ref)
    ye_ref = bn.batch_norm_eval_plain(x64, rm.double(), rv.double(), w64,
                                      b64)
    errs = {k: _ulps(g, r) for k, g, r in (
        ('y', y, y_ref), ('mean', mean, mean_ref), ('var', var, var_ref),
        ('rstd', rstd, rstd_ref), ('eval', ye, ye_ref), ('dx', dx, dx_ref),
        ('dweight', dw, dw_ref), ('dbias', db, db_ref))}
    print('batch_norm ulps', shape, offset, errs)
    for k, e in errs.items():
        assert e <= (BN_FWD_U if k in ('y', 'mean', 'var', 'rstd', 'eval')
                     else BN_BWD_U), (k, errs)


@pytest.mark.parametrize('c', [1, 16])
def test_batch_norm_module_routes_to_the_kernels(cuda, c):
    """``BatchNorm`` on a routed shape (C channels of 2^20 elements each):
    training launches the backward kernels, and the forward's at one
    channel; y is the kernels' normalize at one channel (within the limits
    above of the float64 plain version) and above it cuDNN's one call,
    ``F.batch_norm``'s bit for bit, whose mean and rstd the backward and
    the running statistics take; the gradients are the plain versions'
    within the limits, and the running statistics 0.9 * old + 0.1 * batch
    with the biased variance.  Under ``checkpoint`` the recompute runs a
    second forward and leaves the statistics alone: statistics and
    gradients bit for bit the plain forward's.  Eval under ``no_grad``
    launches the eval kernel; eval with gradients on takes
    ``F.batch_norm``."""
    from list_tpu_torch.models.norm import BatchNorm, checkpoint
    from list_tpu_torch.ops.cuda import batch_norm as bn
    shape = (2, c, 64, 128, 64)
    assert bn.routes(5, torch.float32, c, 2 ** 20)
    assert bn.normalizes(c) is (c == 1)
    x, w, b, dy = _bn_inputs(shape, cuda, 7 + c)
    mods = [BatchNorm(c).to(cuda) for _ in range(2)]
    for m in mods:
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
            m.running_mean.fill_(0.25)
            m.running_var.fill_(2.0)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    f = int(c == 1)  # forward launches of a training forward
    before = (bn.launches, bn.bwd_launches)
    y = mods[0](xs[0])
    y.backward(dy)
    torch.cuda.synchronize()
    assert (bn.launches, bn.bwd_launches) == (before[0] + f, before[1] + 1)
    checkpoint(mods[1], xs[1]).backward(dy)
    torch.cuda.synchronize()
    assert (bn.launches, bn.bwd_launches) \
        == (before[0] + 3 * f, before[1] + 2)
    for name in ('running_mean', 'running_var'):
        assert torch.equal(getattr(mods[0], name), getattr(mods[1], name))
    for got, ref in ((xs[1].grad, xs[0].grad),
                     (mods[1].weight.grad, mods[0].weight.grad),
                     (mods[1].bias.grad, mods[0].bias.grad)):
        assert torch.equal(got, ref)
    x64, w64, b64, dy64 = (t.double() for t in (x, w, b, dy))
    y_ref, mean_ref, var_ref = bn.batch_norm_train_plain(x64, w64, b64)
    dx_ref, dw_ref, db_ref = bn.batch_norm_backward_plain(
        x64, dy64, w64, mean_ref, torch.rsqrt(var_ref + bn.EPS))
    if c == 1:
        assert _ulps(y, y_ref) <= BN_FWD_U
    else:
        assert torch.equal(y, torch.nn.functional.batch_norm(
            x, None, None, w, b, True, 0.0, bn.EPS))
    m = mods[0]
    assert _ulps(m.running_mean, 0.9 * 0.25 + 0.1 * mean_ref) <= BN_FWD_U
    assert _ulps(m.running_var, 0.9 * 2.0 + 0.1 * var_ref) <= BN_FWD_U
    assert _ulps(xs[0].grad, dx_ref) <= BN_BWD_U
    assert _ulps(m.weight.grad, dw_ref) <= BN_BWD_U
    assert _ulps(m.bias.grad, db_ref) <= BN_BWD_U
    with torch.no_grad():
        m.eval()
        ye = m(x)
    torch.cuda.synchronize()
    assert (bn.launches, bn.bwd_launches) \
        == (before[0] + 3 * f + 1, before[1] + 2)
    assert _ulps(ye, bn.batch_norm_eval_plain(
        x64, m.running_mean.double(), m.running_var.double(), w64,
        b64)) <= BN_FWD_U
    ye_grad = m(x.detach().requires_grad_())  # eval with grads: F.batch_norm
    assert (bn.launches, bn.bwd_launches) \
        == (before[0] + 3 * f + 1, before[1] + 2)
    torch.testing.assert_close(ye_grad, ye, atol=1e-5, rtol=1e-5)


def test_batch_norm_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    from list_tpu_torch.ops.cuda import batch_norm as bn
    w = torch.ones(4, device=cuda)
    for x, err in ((torch.zeros(2, 4, 8, 8, device=cuda, dtype=torch.float64),
                    TypeError),
                   (torch.zeros(2, 4, 8, device=cuda), ValueError),
                   (torch.zeros(2, 5, 8, 8, device=cuda), ValueError)):
        with pytest.raises(err):
            bn.batch_norm_train(x, w, w)
        with pytest.raises(err):
            bn.batch_norm_eval(x, w, w, w, w)


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


# ---- the perceptual sample (ops/cuda/percep.py) ----------------------------

# a LIST-like learned camera (pixels inside the map, depth near 1), DISN's
# orthographic one (depth 1), and a wide one whose pixels run past both
# edges of the map, so that the clamp and the clamped +1 corners are taken
PERCEP_CAMERAS = dict(
    learned=[[60.0, 1.0, 0.1], [2.0, -60.0, 0.05], [0.5, 0.3, 0.02],
             [68.0, 68.0, 1.0]],
    ortho=[[68.0, 0.0, 0.0], [0.0, -68.0, 0.0], [0.0, 0.0, 0.0],
           [68.0, 68.0, 1.0]],
    wide=[[150.0, 3.0, 0.05], [4.0, -150.0, 0.02], [1.0, 0.5, 0.01],
          [68.0, 68.0, 1.0]])
# (R, slab rows S, first row, C, coordinate order, camera, map dtype):
# LIST's order at 128^3 and C = 512 (the mesh cells' slab), DISN's
# expanded views, one 256^3 slab of 8, the map's edges, a tiny model's
# width (C = 24: 3 vectors a row, fewer than a warp's lanes), and f32 maps
# (a decode at compute_dtype f32) at C = 512 and at C = 12
PERCEP_CASES = {
    'list_128': (128, 128, 0, 512, 'list', 'learned', 'bf16'),
    'disn_views': (128, 16, 48, 512, 'disn', 'ortho', 'bf16'),
    'slab_256': (256, 8, 128, 512, 'list', 'learned', 'bf16'),
    'edges': (64, 8, 0, 512, 'list', 'wide', 'bf16'),
    'c_24': (32, 4, 8, 24, 'list', 'learned', 'bf16'),
    'f32_list': (64, 8, 16, 512, 'list', 'learned', 'f32'),
    'f32_disn_c_12': (32, 32, 0, 12, 'disn', 'wide', 'f32'),
}
PERCEP_DTYPES = dict(bf16=torch.bfloat16, f32=torch.float32)


def _percep_inputs(case, dev):
    from list_tpu_torch.ops.cuda import percep
    R, S, xs, C, order, cam, dt = PERCEP_CASES[case]
    ms = percep.PERCEP_MAP
    g = torch.Generator(device='cpu').manual_seed(R + C + xs)
    flat = torch.randn(ms * ms, C, generator=g).to(dev, PERCEP_DTYPES[dt])
    t = torch.tensor(PERCEP_CAMERAS[cam], device=dev)
    step = 1.0 / (R - 1)
    ar = torch.arange(R, dtype=torch.float32, device=dev)
    ar_s = torch.arange(S, dtype=torch.float32, device=dev)
    fx = ((ar_s + xs) * step - 0.5)[:, None, None].expand(S, R, R)
    fy = (ar * step - 0.5)[None, :, None].expand(S, R, R)
    fz = (ar * step - 0.5)[None, None, :].expand(S, R, R)
    ps = (2.0 * fz, 2.0 * fy, 2.0 * fx) if order == 'list' else (fx, fy, fz)
    return flat, t, ps


def _percep_f64_errors(flat, t, ps, outs, rel, chunk=2 ** 18):
    """max |out - ref| over the queries of each of ``outs`` (n, C), ref
    the bilinear in float64 at the plain version's f32 pixels; and the
    per-element bound's worst use, max |out - ref| / (rel |ref| + 2^-20
    max |map|), for each."""
    from list_tpu_torch.ops.cuda import percep
    ms = percep.PERCEP_MAP
    xpix, ypix = percep.pixel_coords(t, *ps)
    x, y = xpix.reshape(-1).double(), ypix.reshape(-1).double()
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=ms - 1), (y0 + 1).clamp(max=ms - 1)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    m = flat.double()
    floor = 2.0 ** -20 * float(m.abs().max())
    errs, uses = [0.0] * len(outs), [0.0] * len(outs)
    for a in range(0, x.numel(), chunk):
        b = slice(a, a + chunk)
        ref = ((1 - wy[b]) * ((1 - wx[b]) * m[y0[b] * ms + x0[b]]
                              + wx[b] * m[y0[b] * ms + x1[b]])
               + wy[b] * ((1 - wx[b]) * m[y1[b] * ms + x0[b]]
                          + wx[b] * m[y1[b] * ms + x1[b]]))
        for i, out in enumerate(outs):
            e = (out[b].double() - ref).abs()
            errs[i] = max(errs[i], float(e.max()))
            uses[i] = max(uses[i], float(
                (e / (rel * ref.abs() + floor)).max()))
    return errs, uses, (xpix, ypix)


@pytest.mark.parametrize('case', list(PERCEP_CASES))
def test_percep_sample_kernel_matches_plain_and_float64(cuda, case):
    """The kernel against float64 at the plain version's f32 pixels (the
    same four corners and weights) and against the plain version.  A bf16
    map: the kernel's f32 bilinear is rounded to bf16 once, so per element
    |kernel - f64| <= 2^-8 |f64| (one bf16 round-off) + 2^-20 max |map|
    (its f32 arithmetic on the corners); the plain version rounds its
    bf16 weights and each of its nine passes, so the kernel's largest
    error is at most the plain version's plus one bf16 round-off of
    max |f64|.  An f32 map: nothing is rounded to bf16, so per element
    |kernel - f64| <= 2^-20 max |map| (the few f32 round-offs of the
    bilinear, each at most 2^-24 of the largest corner), and the largest
    error is at most the plain version's plus that."""
    from list_tpu_torch.ops.cuda import percep
    flat, t, ps = _percep_inputs(case, cuda)
    dt = flat.dtype
    rel = 2.0 ** -8 if dt == torch.bfloat16 else 0.0
    before = percep.launches
    got = percep.percep_sample(flat, t, *ps, dt)
    torch.cuda.synchronize()
    assert percep.launches == before + 1
    n, C = ps[0].numel(), flat.shape[1]
    assert got.shape == (n, C) and got.dtype == dt
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    plain = percep.percep_sample_plain(flat, t, *ps, dt)
    (err, plain_err), (use, _), (xpix, ypix) = _percep_f64_errors(
        flat, t, ps, (got, plain), rel)
    scale = float(flat.double().abs().max())
    if PERCEP_CASES[case][5] == 'wide':
        for pix in (xpix, ypix):
            assert bool((pix == 0).any()) and bool((pix == 136).any())
    print(f'percep {case}: kernel {err:.3g}, plain {plain_err:.3g} off '
          f'float64; bound use {use:.3f}')
    assert bool(torch.isfinite(got.float()).all())
    assert use <= 1.0
    if dt == torch.bfloat16:
        assert err <= plain_err + 2.0 ** -8 * scale
    else:
        assert err <= plain_err + 2.0 ** -20 * scale
    # the kernel and the plain version pick the same corners: their gap
    # is within both versions' rounding (the plain version's own error
    # against float64, then the kernel's per-element bound)
    gap = float((got.float() - plain.float()).abs().max())
    assert gap <= plain_err + rel * scale + 2.0 ** -20 * scale


def test_percep_sample_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """Another dtype than a bf16 or f32 map and its own output type, rows
    that are not whole 16-byte vectors (C = 13 in bf16) or not 16-byte
    aligned, a camera off the card, a map that is not (137^2, C) and
    coordinates that are not (S, R, R) raise before any launch."""
    from list_tpu_torch.ops.cuda import percep
    flat, t, ps = _percep_inputs('c_24', cuda)
    ms = percep.PERCEP_MAP
    odd = flat[:, :13].contiguous()
    shifted = torch.empty(ms * ms * 24 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(ms * ms, 24)
    before = percep.launches
    for args, err in (((flat.double(), t, *ps, torch.float64), TypeError),
                      ((flat, t, *ps, torch.float32), TypeError),
                      ((odd, t, *ps, torch.bfloat16), ValueError),
                      ((shifted, t, *ps, torch.bfloat16), ValueError),
                      ((flat, t.cpu(), *ps, torch.bfloat16), ValueError),
                      ((flat[:-1], t, *ps, torch.bfloat16), ValueError),
                      ((flat, t, ps[0][0], *ps[1:], torch.bfloat16),
                       ValueError)):
        with pytest.raises(err):
            percep.percep_sample(*args)
    assert percep.launches == before


# ---- the voxel work (ops/cuda/voxel.py) -----------------------------------

# LIST's dense decode at a 128^3 slab from a 128^3 encoding: each kept
# group's (r, C) and the coarse term (16^3 and 8^3 scales of 512 channels)
VOXEL_CASES = {'group_128x17': (128, 17), 'group_64x32': (64, 32),
               'group_32x64': (32, 64), 'coarse': None}
VOXEL_DELTA = 0.0722


def _voxel_check(got, plain, terms, R, x0, nx, rel=2.0 ** -8):
    """(kernel's, plain version's) (max abs error, tolerance use) against
    float64 over every element (``voxel.f64_errors``)."""
    from list_tpu_torch.ops.cuda import voxel
    return tuple(voxel.f64_errors(t, terms, R, x0, nx, VOXEL_DELTA, rel=rel)
                 for t in (got, plain))


@pytest.mark.parametrize('case', list(VOXEL_CASES))
def test_voxel_taps_kernel_matches_float64(cuda, case):
    """One launch at a 128^3 slab on N(0, 1) bf16 volumes: every element
    within one bf16 round-off of float64 (2^-8 |f64| + 2^-20 of the same
    sum over |volumes|), where the plain version rounds after each of its
    passes (its error printed beside); the 17-channel group takes single
    channels, the others 4-channel vectors."""
    from list_tpu_torch.ops.cuda import voxel
    R, bf = 128, torch.bfloat16
    g = torch.Generator(device='cpu').manual_seed(29)
    before = voxel.launches
    if VOXEL_CASES[case] is None:
        taps = [[torch.randn(r, r, r, 512, generator=g).to(cuda, bf)
                 for _ in range(7)] for r in (16, 8)]
        args = (taps, R, R, VOXEL_DELTA, -0.5, 0.5, (0, R), True)
        got = voxel.CoarseTerm(*args).slab(0)
        torch.cuda.synchronize()
        assert voxel.launches == before + 1 and voxel.vec_path == 4
        plain = voxel.CoarseTerm(*args, plain=True).slab(0)
        terms = [(P[t], (sx, sy, sz)) for P in taps
                 for t, (sx, (sy, sz)) in enumerate(voxel.TAPS)]
        checks = [_voxel_check(got, plain, terms, R, 0, R)]
    else:
        r, C = VOXEL_CASES[case]
        vol = torch.randn(r, r, r, C, generator=g).to(cuda, bf)
        got = voxel.KeptTaps(vol, R, R, VOXEL_DELTA, -0.5, 0.5).slab(0)
        torch.cuda.synchronize()
        assert voxel.launches == before + 1
        assert voxel.vec_path == (1 if C % 4 else 4)
        plain = voxel.KeptTaps(vol, R, R, VOXEL_DELTA, -0.5, 0.5,
                               plain=True).slab(0)
        assert [tuple(t.shape) for t in got] == [tuple(t.shape)
                                                 for t in plain]
        cols = [(0, t * C) for t in range(5)] + [(1, 0), (2, 0)]
        checks = [_voxel_check(got[i][:, o:o + C], plain[i][:, o:o + C],
                               [(vol, (sx, sy, sz))], R, 0, R)
                  for (i, o), (sx, (sy, sz)) in zip(cols, voxel.TAPS)]
    (err, use), (plain_err, plain_use) = (
        (max(c[j][0] for c in checks), max(c[j][1] for c in checks))
        for j in (0, 1))
    print(f'voxel {case}: kernel {err:.3g} ({use:.3f} of one bf16 '
          f'round-off), plain {plain_err:.3g} ({plain_use:.3f}) off float64')
    assert use <= 1.0


# (R, structured, kept (r, C) or coarse scales, slab, x range, hoisted):
# the t-major stacks at C = 3 (single channels) and an x range whose rows
# are no whole number of the kernel's 16-row walk; the parts at r = R (the
# identity plans) and C = 12; the coarse term of three scales per slab in
# f32 and hoisted over an x range in bf16
VOXEL_SHAPES = [
    ('stacks_r20_c3', 40, False, (20, 3), 8, (8, 32), None),
    ('parts_r40_c12', 40, True, (40, 12), 8, (16, 40), None),
    ('coarse_per_slab_f32', 40, None, (10, 5, 3), 8, (8, 32), False),
    ('coarse_hoisted_bf16', 40, None, (10, 5, 3), 8, (8, 32), True)]


@pytest.mark.parametrize('name,R,structured,shape,slab,x_range,outside',
                         VOXEL_SHAPES, ids=[c[0] for c in VOXEL_SHAPES])
def test_voxel_taps_kernel_shapes(cuda, name, R, structured, shape, slab,
                                  x_range, outside):
    """Each slab of the range against float64 (one round-off of the
    output's type: bf16, or f32 for the per-slab coarse term), one launch
    a slab (a kept group; a coarse term per slab) or one a range (the
    hoisted coarse term)."""
    from list_tpu_torch.ops.cuda import voxel
    bf = torch.bfloat16
    g = torch.Generator(device='cpu').manual_seed(31)
    before = voxel.launches
    ks = range(x_range[0] // slab, x_range[1] // slab)
    if structured is None:
        taps = [[torch.randn(r, r, r, 16, generator=g).to(cuda, bf)
                 for _ in range(7)] for r in shape]
        term = voxel.CoarseTerm(taps, R, slab, VOXEL_DELTA, -0.5, 0.5,
                                x_range, outside)
        terms = [(P[t], (sx, sy, sz)) for P in taps
                 for t, (sx, (sy, sz)) in enumerate(voxel.TAPS)]
        outs = [(term.slab(k), terms) for k in ks]
        want = 1 if outside else len(ks)
        rel = 2.0 ** -8 if outside else 2.0 ** -24
        assert all(o.dtype == (bf if outside else torch.float32)
                   for o, _ in outs)
    else:
        r, C = shape
        vol = torch.randn(r, r, r, C, generator=g).to(cuda, bf)
        kt = voxel.KeptTaps(vol, R, slab, VOXEL_DELTA, -0.5, 0.5,
                            structured=structured)
        outs = []
        for k in ks:
            got = kt.slab(k)
            if structured:
                cols = [(got[0], t * C) for t in range(5)] \
                    + [(got[1], 0), (got[2], 0)]
            else:
                assert tuple(got[0].shape) == (7, slab * R * R, C)
                cols = [(got[0][t], 0) for t in range(7)]
            outs += [(a[:, o:o + C], [(vol, (sx, sy, sz))])
                     for (a, o), (sx, (sy, sz)) in zip(cols, voxel.TAPS)]
        want, rel = len(ks), 2.0 ** -8
    torch.cuda.synchronize()
    assert voxel.launches == before + want
    n = len(outs) // len(ks)
    for i, (out, terms) in enumerate(outs):
        k = ks[i // n]
        _, use = voxel.f64_errors(out, terms, R, k * slab, slab, VOXEL_DELTA,
                                  rel=rel)
        assert use <= 1.0, (name, k, use)


def _voxel_decoder(cuda):
    """A LIST-shaped decode at R = 64 from VoxelEncoder2-like features
    (64^3 x 1, 64^3 x 16, 32^3 x 32 kept; 16^3 x 64, 8^3 x 128 and 4^3 x
    128 projected), two perceptual maps and K1's widths, on the CPU and on
    the card."""
    torch.manual_seed(3)
    chans = ((64, 1), (64, 16), (32, 32), (16, 64), (8, 128), (4, 128))
    din = sum(c for _, c in chans) * 7 + 24 + 3
    dec = torch.nn.Module()
    for name, a, b in (('fc_0', din, 512), ('fc_1', 512, 256),
                       ('fc_2', 256, 256), ('fc_out', 256, 1)):
        setattr(dec, name, torch.nn.Linear(a, b))
    vox = [torch.rand(1, r, r, r, c) for r, c in chans]
    feat = [torch.randn(1, 14, 14, 8), torch.randn(1, 7, 7, 16)]
    tm = torch.tensor([[[60., 0., 0.], [0., 60., 0.], [0., 0., 1.],
                        [68., 68., 2.]]])
    cpu = (dec, vox, feat, tm)
    card = (copy.deepcopy(dec).to(cuda), [v.to(cuda) for v in vox],
            [f.to(cuda) for f in feat], tm.to(cuda))
    return cpu, card


def test_voxel_taps_in_the_dense_decode_on_the_card(cuda):
    """``dense_grid_sdf`` at R = 64 on the card (K1, the kernel's 2 kept
    groups and 1 hoisted coarse term: 3 launches) against the CPU's plain
    decode within 2e-3 + 2e-2 max |grid|; in slabs of 16, the two halves
    of the x rows give the whole grid's slabs bit for bit (4 x 2 + 1 and
    2 x (2 x 2 + 1) launches)."""
    from list_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from list_tpu_torch.ops.dense_grid import dense_grid_sdf
    cpu, card = _voxel_decoder(cuda)
    with torch.inference_mode():
        reset_launch_counts()
        got = dense_grid_sdf(*card, 64)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert (counts['voxel_taps'], counts['fused_stack_head'],
                counts['percep_sample']) == (3, 1, 1)
        ref = dense_grid_sdf(*cpu, 64)
        err = float((got.cpu() - ref).abs().max())
        assert err <= 2e-3 + 2e-2 * float(ref.abs().max()), err
        reset_launch_counts()
        whole = dense_grid_sdf(*card, 64, slab=16)
        halves = torch.cat([dense_grid_sdf(*card, 64, slab=16, x_range=r)
                            for r in ((0, 32), (32, 64))])
        assert launch_counts()['voxel_taps'] == 9 + 10
        assert torch.equal(whole, halves)


def test_voxel_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """f32 volumes on the card, and a group whose volume lies on another
    device than its output, raise before any launch."""
    from list_tpu_torch.ops.cuda import voxel
    before = voxel.launches
    with pytest.raises(TypeError, match='voxel_taps kernel takes bf16'):
        voxel.KeptTaps(torch.zeros(8, 8, 8, 4, device=cuda), 16, 16,
                       VOXEL_DELTA, -0.5, 0.5)
    with pytest.raises(TypeError, match='voxel_taps kernel takes bf16'):
        voxel.CoarseTerm([[torch.zeros(4, 4, 4, 8, device=cuda)] * 7], 16,
                         16, VOXEL_DELTA, -0.5, 0.5, (0, 16), True)
    assert voxel.launches == before


# ---- several cards ---------------------------------------------------------

def _need_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f'needs {n} cards, torch sees '
                    f'{torch.cuda.device_count()}')


def test_kernels_launch_on_their_operands_card(cuda):
    """Each kernel on cuda:1 while cuda:0 is the current device: K2's
    forward, its dx and K3 through Conv3x3x3Fn's backward, K3 alone, K1,
    K4, the perceptual sample and voxel_taps each launch on cuda:1
    (counted once a launch), agree with their plain versions there (the
    conv's tolerances as above, the heads' 1e-2 + 1e-2 |plain|, the
    sample's 0.05 + 0.05 |plain|: a few bf16 round-offs of maps of unit
    scale; voxel_taps with float64 within one bf16 round-off), and leave
    cuda:0 current."""
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
    from list_tpu_torch.ops.cuda import percep
    flat, t, ps = _percep_inputs('c_24', dev)
    before = percep.launches
    got = percep.percep_sample(flat, t, *ps, torch.bfloat16)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0 and got.device == dev
    assert percep.launches == before + 1
    torch.testing.assert_close(
        got.float(), percep.percep_sample_plain(flat, t, *ps,
                                                torch.bfloat16).float(),
        atol=0.05, rtol=0.05)
    from list_tpu_torch.ops.cuda import voxel
    vol = torch.randn(16, 16, 16, 8, generator=g_).to(dev, torch.bfloat16)
    before = voxel.launches
    got = voxel.KeptTaps(vol, 32, 32, VOXEL_DELTA, -0.5, 0.5).slab(0)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0 and got[0].device == dev
    assert voxel.launches == before + 1
    _, use = voxel.f64_errors(got[1], [(vol, (-1, 0, 0))], 32, 0, 32,
                              VOXEL_DELTA)
    assert use <= 1.0


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


# ---- no waits on the card once the constants are there -------------------------

def test_warm_encode_decode_and_step_do_not_wait_on_the_card(cuda,
                                                             card_executor):
    """After a warm call, an encode and a 128^3 dense decode of the
    full-width LIST and a small train step (vox_res 32, batch 2, 1,024
    queries, remat, ``--remat_save_samples 1``) make no synchronizing call
    under ``torch.cuda.set_sync_debug_mode('error')`` -- the step's batch
    upload and closing synchronization aside -- and no tensor of a host
    array (``ops/consts.py`` keeps their constants on the card)."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    from tools.torch_decode_probe import (numpy_uploads, sync_sites,
                                          waits_allowed)
    ex, imgs, _, _ = card_executor
    img = torch.as_tensor(imgs[2], device=cuda)
    plan = ex._dense_plan()
    with torch.inference_mode():
        ex._decode(ex.model.encode(img), *plan)
        torch.cuda.synchronize()
        with numpy_uploads() as uploads, sync_sites('error'):
            grid = ex._decode(ex.model.encode(img), *plan)
        torch.cuda.synchronize()
    assert uploads == [] and grid.shape == (128,) * 3

    cfg = default_config(vox_res=32, train_batch_size=2,
                         sample_point_density=1024, sdf_scale=10.0,
                         remat_save_samples=1)
    rng = np.random.RandomState(2)
    batch = {'rgb_image': rng.rand(2, 224, 224, 3).astype(np.float32),
             'points': rng.uniform(-0.5, 0.5, (2, 1024, 3)).astype(
                 np.float32),
             'values': (rng.randn(2, 1024) * 0.05).astype(np.float32),
             'occ': (rng.rand(2, 32, 32, 32) > 0.9).astype(np.float32)}
    torch.manual_seed(2)
    tex = LISTExecutor(cfg, LIST.from_config(cfg))
    tex.train(batch)
    tex._to_device = waits_allowed(tex._to_device)
    tex._sync = waits_allowed(tex._sync)
    with numpy_uploads() as uploads, sync_sites('error'):
        _, losses = tex.train(batch)
    assert len(uploads) == len(tex._train_keys(batch))  # the batch only
    assert all(np.isfinite(float(v)) for v in losses.values())


def test_split_decode_from_one_thread_waits_on_no_card(cuda, monkeypatch):
    """Under --mesh_shape N (every card), a warm split decode at 256^3 (8
    slabs a card on 4 cards) is queued from the calling thread alone, the
    cards' slabs in turns, makes no synchronizing call and no tensor of a
    host array, and gives the one-card grid bit for bit."""
    _need_cards(2)
    import threading
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor, executors
    from tools.torch_decode_probe import numpy_uploads, sync_sites
    n = next(k for k in (8, 4, 2) if torch.cuda.device_count() >= k)
    torch.cuda.set_device(0)
    torch.manual_seed(0)
    model = LIST.from_config(default_config(vox_res=128))
    one = LISTExecutor(default_config(vox_res=256, sdf_scale=10.0), model)
    split = LISTExecutor(default_config(vox_res=256, sdf_scale=10.0,
                                        mesh_shape=[n]), model)
    img = torch.as_tensor(np.random.RandomState(0).rand(
        1, 224, 224, 3).astype(np.float32), device=cuda)
    order = []
    real = executors.dense_grid_slabs

    def spy(*a, **kw):
        for out in real(*a, **kw):
            order.append((threading.get_ident(), out.device.index))
            yield out

    monkeypatch.setattr(executors, 'dense_grid_slabs', spy)
    with torch.inference_mode():
        enc = model.encode(img)
        ref = one._decode(enc, *one._dense_plan(1))
        plan = split._dense_plan(n)
        split._decode(enc, *plan)
        for i in range(n):
            torch.cuda.synchronize(i)
        order.clear()
        with numpy_uploads() as uploads, sync_sites('error'):
            got = split._decode(enc, *plan)
        for i in range(n):
            torch.cuda.synchronize(i)
    assert {t for t, _ in order} == {threading.get_ident()}
    assert [c for _, c in order] == list(range(n)) * (256 // n // plan[0])
    assert uploads == [] and torch.equal(got, ref)
