"""BatchNorm of few-channel volumes: the training forward, its backward and
the eval forward, with each channel's extent split over the whole card.

Replaces no TPU kernel: the JAX package's BatchNorm is flax's, left to XLA.
On a CUDA tensor it takes the place of cuDNN's SPATIAL-mode kernels, which
give each channel to one block and so leave most of the card idle at one
to 32 channels (the voxel encoder's 1, 1, 16 and 32 channels at 128^3 and
64^3).  The CUDA source is ``csrc/batch_norm.cu``; its header states the
bound on an H100 and what the design does about it.

``routes(dim, dtype, C, M)`` is the rule that sends a shape here:
4-D and 5-D float32 with at most ``MAX_CHANNELS`` channels of at least
``MIN_EXTENT`` elements each (M = B * D * H * W), set from the per-shape
timings of cuDNN against these kernels on an H100 (PERF.md).  It reads
nothing else.  A routed training forward takes y and the batch statistics
from the kernels where ``normalizes(C)``, else from one cuDNN call (the
call ``F.batch_norm`` makes, which returns its mean and rstd too), so the
running statistics need no read of their own and the backward uses the
statistics y was made with; the backward and the eval forward are the
kernels'.

``batch_norm_train(x, w, b)`` -> (y, batch mean, biased batch variance),
differentiable in x, w and b through ``BatchNormFn``;
``batch_norm_eval(x, running_mean, running_var, w, b)`` -> y.  CPU tensors
take the plain versions beside them; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from list_tpu_torch.device import H100_SXM
from list_tpu_torch.ops.cuda import build

SOURCE = 'list_tpu_torch/csrc/batch_norm.cu'
EPS = 1e-5
# The routing rule's thresholds (PERF.md, the per-shape table).
MAX_CHANNELS = 32
MIN_EXTENT = 2 ** 18
NORMALIZE_CHANNELS = 1
# Launch geometry: blocks of THREADS threads, about WAVES * BLOCKS_PER_SM
# blocks on each SM over all channels, each block at least MIN_CHUNK
# elements of its channel and a multiple of STEP (a float4 a thread).
THREADS = 256
BLOCKS_PER_SM = 8
WAVES = 2
STEP = 4 * THREADS
MIN_CHUNK = 8 * STEP
MAX_CHUNK = 2 ** 24  # the kernels hold a block's count exactly in f32
# Kernel launches since the last reset (launches only, never plain or
# cuDNN calls): ``launches`` the forwards (a training forward's statistics
# and normalize count one; eval one), ``bwd_launches`` the backwards.
launches = 0
bwd_launches = 0


def routes(dim: int, dtype: torch.dtype, channels: int, extent: int) -> bool:
    """Whether a BatchNorm of a ``dim``-D ``dtype`` tensor with
    ``channels`` channels of ``extent`` elements each goes to the kernels
    (on a CUDA tensor) rather than to ``F.batch_norm``."""
    return (dim in (4, 5) and dtype == torch.float32
            and 1 <= channels <= MAX_CHANNELS and extent >= MIN_EXTENT)


def normalizes(channels: int) -> bool:
    """Whether a routed training forward runs the kernels, rather than
    cuDNN's training forward, for y and the statistics (PERF.md: above one
    channel the benchmark's first-step loss check, set against cuDNN's f32
    BatchNorm, reads this kernel's rounding of the 16- and 32-channel
    features as it reads float64's)."""
    return channels <= NORMALIZE_CHANNELS


def geometry(channels: int, extent: int, sms: int) -> Tuple[int, int]:
    """(k, chunk): k blocks a channel, each owning ``chunk`` consecutive
    elements of the channel (the last block the rest)."""
    want = max(1, -(-WAVES * BLOCKS_PER_SM * sms // channels))
    chunk = min(max(MIN_CHUNK, -(-extent // want)), MAX_CHUNK)
    chunk = -(-chunk // STEP) * STEP
    return -(-extent // chunk), chunk


def batch_norm_train_plain(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, eps: float = EPS):
    """(y, mean, biased variance) over every axis but 1, in x's dtype."""
    dims = [0] + list(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    shape = [1, -1] + [1] * (x.dim() - 2)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean.view(shape)) * (rstd * w).view(shape) + b.view(shape)
    return y, mean, var


def batch_norm_eval_plain(x: torch.Tensor, running_mean: torch.Tensor,
                          running_var: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    shape = [1, -1] + [1] * (x.dim() - 2)
    scale = torch.rsqrt(running_var + eps) * w
    return (x - running_mean.view(shape)) * scale.view(shape) \
        + b.view(shape)


def batch_norm_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                              w: torch.Tensor, mean: torch.Tensor,
                              rstd: torch.Tensor):
    """(dx, dweight, dbias) of the training forward, from its batch mean
    and rstd: dx = w * rstd * (dy - sum dy / M - xhat * sum dy * xhat / M)."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    m = x.numel() // x.shape[1]
    xhat = (x - mean.view(shape)) * rstd.view(shape)
    db = dy.sum(dims)
    dw = (dy * xhat).sum(dims)
    dx = (w * rstd).view(shape) * (dy - (db / m).view(shape)
                                   - xhat * (dw / m).view(shape))
    return dx, dw, db


def _check(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dtype != torch.float32 or any(p.dtype != torch.float32
                                       for p in params):
        raise TypeError(f'batch_norm kernels take float32, got {x.dtype}')
    if x.dim() not in (4, 5):
        raise ValueError(f'batch_norm kernels take 4-D or 5-D input, got '
                         f'{tuple(x.shape)}')
    if any(p.shape != (x.shape[1],) or p.device != x.device
           or not p.is_contiguous() for p in params):
        raise ValueError('batch_norm: a per-channel operand does not match '
                         'the input')
    if not 1 <= x.shape[1] <= 65535 or x.numel() == 0:
        raise ValueError(f'batch_norm kernels take 1 to 65535 channels and '
                         f'a non-empty input, got {tuple(x.shape)}')


def _layout(x: torch.Tensor, *others: torch.Tensor):
    """(C, S, M, k, chunk, vec) of a launch on contiguous x (and others of
    its shape): float4 access where S is a multiple of 4 and every base
    address 16-byte aligned."""
    C = x.shape[1]
    S = x[0, 0].numel()
    M = x.numel() // C
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    k, chunk = geometry(C, M, sms)
    vec = S % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    return C, S, M, k, chunk, int(vec)


_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def _fn(name: str, argtypes):
    fn = getattr(build.load('batch_norm'), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _count(bwd: bool = False) -> None:
    global launches, bwd_launches
    with build.count_lock:
        if bwd:
            bwd_launches += 1
        else:
            launches += 1


def _stats(x):
    """(mean, biased variance, rstd) a channel of contiguous x."""
    C, S, M, k, chunk, vec = _layout(x)
    mean, var, rstd = (torch.empty(C, dtype=torch.float32, device=x.device)
                       for _ in range(3))
    part = torch.empty(C * k * 2, dtype=torch.float32, device=x.device)
    fn = _fn('bn_stats_f32', [_P] * 5 + [_I, _LL, _LL, _I, _LL, _I,
                                          ctypes.c_float, _P])
    build.launch(x.device, 'batch_norm statistics', fn, x.data_ptr(),
                 mean.data_ptr(), var.data_ptr(), rstd.data_ptr(),
                 part.data_ptr(), C, S, M, k, chunk, vec, EPS)
    return mean, var, rstd


def _apply(x, mean, stat, w, b, eval_: bool):
    """(x - mean) * w * rstd + b, rstd = ``stat`` or, in eval, from the
    running variance ``stat``."""
    y = torch.empty_like(x)
    C, S, M, k, chunk, vec = _layout(x, y)
    fn = _fn('bn_apply_f32', [_P] * 6 + [_I, _LL, _LL, _I, _LL, _I, _I,
                                          ctypes.c_float, _P])
    build.launch(x.device, 'batch_norm normalize', fn, x.data_ptr(),
                 y.data_ptr(), mean.data_ptr(), stat.data_ptr(),
                 w.data_ptr(), b.data_ptr(), C, S, M, k, chunk, vec,
                 int(eval_), EPS)
    return y


def _forward_train(x, w, b):
    _check(x, w, b)
    if not normalizes(x.shape[1]):
        y, mean, rstd, _ = torch.ops.aten.cudnn_batch_norm(
            x, w, b, None, None, True, 0.0, EPS)
        return y, mean, (rstd.pow(-2) - EPS).clamp_min_(0.0), rstd
    mean, var, rstd = _stats(x)
    y = _apply(x, mean, rstd, w, b, False)
    _count()
    return y, mean, var, rstd


def _backward(x, dy, w, mean, rstd, need_dx: bool):
    dx = torch.empty_like(x) if need_dx else None
    C, S, M, k, chunk, vec = _layout(x, dy, *([dx] if need_dx else []))
    dw, db = (torch.empty(C, dtype=torch.float32, device=x.device)
              for _ in range(2))
    part = torch.empty(C * k * 2, dtype=torch.float32, device=x.device)
    coef = torch.empty(C * 3, dtype=torch.float32, device=x.device)
    fn = _fn('bn_backward_f32', [_P] * 10 + [_I, _LL, _LL, _I, _LL, _I, _P])
    build.launch(x.device, 'batch_norm backward', fn, x.data_ptr(),
                 dy.data_ptr(), w.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dx.data_ptr() if need_dx else None,
                 dw.data_ptr(), db.data_ptr(), part.data_ptr(),
                 coef.data_ptr(), C, S, M, k, chunk, vec)
    _count(bwd=True)
    return dx, dw, db


class BatchNormFn(torch.autograd.Function):
    """Training BatchNorm: outputs (y, mean, biased variance), the last two
    not differentiable; saves x, w and the batch mean and rstd (no other
    tensor of x's size)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        if x.device.type == 'cpu':
            y, mean, var = batch_norm_train_plain(x, w, b)
            rstd = torch.rsqrt(var + EPS)
        else:
            y, mean, var, rstd = _forward_train(x.contiguous(), w, b)
        ctx.save_for_backward(x, w, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy: torch.Tensor, _dmean, _dvar):
        x, w, mean, rstd = ctx.saved_tensors
        if x.device.type == 'cpu':
            dx, dw, db = batch_norm_backward_plain(x, dy, w, mean, rstd)
        else:
            dx, dw, db = _backward(x.contiguous(), dy.contiguous(), w, mean,
                                   rstd, ctx.needs_input_grad[0])
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None)


def batch_norm_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(y, batch mean, biased batch variance) of a training BatchNorm."""
    return BatchNormFn.apply(x, w, b)


def batch_norm_eval(x: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """BatchNorm with the running statistics (not differentiable on a CUDA
    tensor: the caller takes it under ``no_grad`` or inference mode)."""
    if x.device.type == 'cpu':
        return batch_norm_eval_plain(x, running_mean, running_var, w, b)
    x = x.contiguous()
    _check(x, running_mean, running_var, w, b)
    y = _apply(x, running_mean, running_var, w, b, True)
    _count()
    return y


def bound_ms(shape, mem_gbs: float = H100_SXM['mem_gbs']) -> dict:
    """Least times in ms on an H100 SXM of one call on an input of
    ``shape``: the training forward reads x twice and writes y, the
    backward reads x and dy twice and writes dx, eval reads x and writes
    y (data-sheet memory rate)."""
    n = 4
    for d in shape:
        n *= d
    ms = n / (mem_gbs * 1e9) * 1e3
    return dict(train=3 * ms, backward=5 * ms, eval=2 * ms)
