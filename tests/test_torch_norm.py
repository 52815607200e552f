"""BatchNorm on the CPU (``models/norm.py``) and the CPU side of the
few-channel BatchNorm kernels (``ops/cuda/batch_norm.py``): the routing
rule as a function of (dim, dtype, C, M) alone, the launch geometry, the
plain versions and the autograd function on CPU tensors against
``F.batch_norm``, and the module's running statistics in training, eval
and under ``checkpoint``.  The kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from list_tpu_torch.models.norm import EPS, BatchNorm, checkpoint
from list_tpu_torch.ops.cuda import batch_norm

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16

# (dim, dtype, C, M, routed): the voxel encoder's seven at batch 8 and its
# four largest at batch 1, the ResNet's conv1 at batch 8 and 16 and its
# last stage, and the edges of the rule
ROUTES = [
    (5, F32, 1, 8 * 128 ** 3, True), (5, F32, 16, 8 * 128 ** 3, True),
    (5, F32, 32, 8 * 64 ** 3, True), (5, F32, 64, 8 * 32 ** 3, False),
    (5, F32, 128, 8 * 16 ** 3, False), (5, F32, 128, 8 * 8 ** 3, False),
    (5, F32, 1, 128 ** 3, True), (5, F32, 16, 128 ** 3, True),
    (5, F32, 32, 64 ** 3, True), (5, F32, 64, 32 ** 3, False),
    (4, F32, 64, 8 * 224 ** 2, False), (4, F32, 64, 16 * 224 ** 2, False),
    (4, F32, 512, 8 * 14 ** 2, False), (4, F32, 32, 2 ** 18, True),
    (4, F32, 33, 2 ** 22, False), (5, F32, 1, 2 ** 18 - 1, False),
    (2, F32, 1, 2 ** 24, False), (3, F32, 16, 2 ** 24, False),
    (5, F64, 16, 8 * 128 ** 3, False), (5, BF16, 16, 8 * 128 ** 3, False),
]


@pytest.mark.parametrize('dim,dtype,c,m,routed', ROUTES)
def test_routing_rule_reads_dim_dtype_channels_extent(dim, dtype, c, m,
                                                      routed):
    assert batch_norm.routes(dim, dtype, c, m) is routed


@pytest.mark.parametrize('c,normalized', [(1, True), (2, False),
                                          (16, False), (32, False)])
def test_training_normalize_is_the_kernels_at_one_channel(c, normalized):
    assert batch_norm.normalizes(c) is normalized


@pytest.mark.parametrize('c,m,sms', [(1, 8 * 128 ** 3, 132),
                                     (16, 8 * 128 ** 3, 132),
                                     (32, 8 * 64 ** 3, 132),
                                     (1, 1155 * 2, 132), (3, 101376, 132),
                                     (16, 2 ** 31, 132), (1, 7, 1)])
def test_geometry_covers_each_channel_once(c, m, sms):
    """Every block owns a non-empty range of at most 2^24 elements, a
    multiple of a float4 a thread; the blocks fill the card about twice
    where the extent allows."""
    k, chunk = batch_norm.geometry(c, m, sms)
    assert chunk % batch_norm.STEP == 0
    assert batch_norm.MIN_CHUNK <= chunk <= batch_norm.MAX_CHUNK
    assert (k - 1) * chunk < m <= k * chunk
    want = batch_norm.WAVES * batch_norm.BLOCKS_PER_SM * sms
    if m >= want * batch_norm.MIN_CHUNK:
        assert want <= c * k <= want + c + batch_norm.STEP


def _inputs(shape, dtype=F64, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = 3.0 + torch.randn(shape, generator=g, dtype=dtype)
    w = 1.0 + 0.5 * torch.randn(c, generator=g, dtype=dtype)
    b = torch.randn(c, generator=g, dtype=dtype)
    dy = torch.randn(shape, generator=g, dtype=dtype)
    return x, w, b, dy


SHAPES = [(2, 1, 5, 7, 33), (3, 16, 4, 5, 6), (2, 32, 17, 19)]


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_versions_are_f_batch_norm(shape):
    """The plain forward, eval and backward against ``F.batch_norm`` and
    its autograd, in float64."""
    x, w, b, dy = _inputs(shape)
    dims = [0] + list(range(2, x.dim()))
    y, mean, var = batch_norm.batch_norm_train_plain(x, w, b)
    torch.testing.assert_close(
        y, F.batch_norm(x, None, None, w, b, True, 0.0, EPS))
    torch.testing.assert_close(mean, x.mean(dims))
    torch.testing.assert_close(var, x.var(dims, correction=0))
    rm, rv = torch.randn(shape[1], dtype=F64), torch.rand(shape[1],
                                                          dtype=F64) + 0.5
    torch.testing.assert_close(
        batch_norm.batch_norm_eval_plain(x, rm, rv, w, b),
        F.batch_norm(x, rm, rv, w, b, False, 0.0, EPS))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    F.batch_norm(xr, None, None, wr, br, True, 0.0, EPS).backward(dy)
    dx, dw, db = batch_norm.batch_norm_backward_plain(
        x, dy, w, mean, torch.rsqrt(var + EPS))
    for got, ref in ((dx, xr.grad), (dw, wr.grad), (db, br.grad)):
        torch.testing.assert_close(got, ref)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('frozen', [False, True])
def test_autograd_function_on_cpu_is_f_batch_norm(shape, frozen):
    """``batch_norm_train`` on CPU tensors: y, the batch mean and biased
    variance (not differentiable), and the gradients of x, w and b (none
    for a frozen weight) as ``F.batch_norm``'s; no launch counted."""
    x, w, b, dy = _inputs(shape, seed=1)
    before = (batch_norm.launches, batch_norm.bwd_launches)
    xr, wr, br = (t.clone().requires_grad_(not (frozen and t is w))
                  for t in (x, w, b))
    y, mean, var = batch_norm.batch_norm_train(xr, wr, br)
    assert not mean.requires_grad and not var.requires_grad
    y.backward(dy)
    xs, ws, bs = (t.clone().requires_grad_(not (frozen and t is w))
                  for t in (x, w, b))
    F.batch_norm(xs, None, None, ws, bs, True, 0.0, EPS).backward(dy)
    torch.testing.assert_close(
        y, F.batch_norm(x, None, None, w, b, True, 0.0, EPS))
    torch.testing.assert_close(var, x.var([0] + list(range(2, x.dim())),
                                          correction=0))
    for got, ref in ((xr, xs), (wr, ws), (br, bs)):
        if ref.grad is None:
            assert got.grad is None
        else:
            torch.testing.assert_close(got.grad, ref.grad)
    assert (batch_norm.launches, batch_norm.bwd_launches) == before


def _module(c, dtype):
    bn = BatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    return bn


# 5-D f32 with one channel of 2^20 elements: a shape the rule routes, so
# the CPU path is shown to stay ``F.batch_norm`` whatever the rule says
MODULE_SHAPES = [(2, 3, 4, 5, 6), (2, 5, 7, 9), (1, 1, 64, 128, 128)]


@pytest.mark.parametrize('shape', MODULE_SHAPES)
def test_module_on_cpu_trains_as_f_batch_norm_with_flax_statistics(shape):
    """Training: ``F.batch_norm`` with the batch statistics; running
    statistics 0.9 * old + 0.1 * batch with the biased variance; eval:
    ``F.batch_norm`` with the running statistics; no launch counted."""
    dtype = F64 if shape[-1] < 64 else F32
    bn = _module(shape[1], dtype)
    x = _inputs(shape, dtype=dtype, seed=2)[0]
    dims = [0] + list(range(2, x.dim()))
    old_m, old_v = bn.running_mean.clone(), bn.running_var.clone()
    before = (batch_norm.launches, batch_norm.bwd_launches)
    y = bn(x)
    torch.testing.assert_close(
        y, F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, EPS))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    torch.testing.assert_close(bn.running_mean, 0.9 * old_m + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * old_v + 0.1 * var)
    bn.eval()
    with torch.no_grad():
        torch.testing.assert_close(
            bn(x), F.batch_norm(x, bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.0, EPS))
    assert (batch_norm.launches, batch_norm.bwd_launches) == before


@pytest.mark.parametrize('shape', MODULE_SHAPES[:2])
def test_module_under_checkpoint_updates_statistics_once(shape):
    """A checkpointed forward and its backward's recompute update the
    running statistics once, as the plain forward does, and give the same
    gradients."""
    x0, _, _, dy = _inputs(shape, seed=3)
    plain, ckpt = _module(shape[1], F64), _module(shape[1], F64)
    ckpt.load_state_dict(plain.state_dict())
    xs = [x0.clone().requires_grad_() for _ in range(2)]
    plain(xs[0]).backward(dy)
    checkpoint(ckpt, xs[1]).backward(dy)
    for name in ('running_mean', 'running_var'):
        torch.testing.assert_close(getattr(ckpt, name), getattr(plain, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(xs[1].grad, xs[0].grad)
    torch.testing.assert_close(ckpt.weight.grad, plain.weight.grad)
    torch.testing.assert_close(ckpt.bias.grad, plain.bias.grad)


def test_bound_counts_the_passes_over_memory():
    """3 passes a training forward, 5 a backward, 2 an eval, at the
    data-sheet 3.35 TB/s: the 16-channel 128^3 volume at batch 8 is
    1.07 GB."""
    b = batch_norm.bound_ms((8, 16, 128, 128, 128))
    one = 8 * 16 * 128 ** 3 * 4 / 3.35e12 * 1e3
    assert b == pytest.approx(dict(train=3 * one, backward=5 * one,
                                   eval=2 * one))
    assert one == pytest.approx(0.3205, abs=1e-4)
