"""K2 and K3: SAME zero-padded 3x3x3 convolution, channel-major f32, no
bias, and its weight gradient.

Replaces the TPU kernels ``conv3x3x3_cmajor`` of
``list_tpu/ops/pallas/stencil3d.py``: K2 the forward (``_fwd_kernel`` /
``_conv_fwd_impl``), K3 the backward's dk (``_dk_kernel`` /
``_conv_dk_impl``).  The CUDA sources are ``csrc/stencil3d.cu`` and
``csrc/conv3x3x3_dk.cu``; their headers state the bound on an H100 and what
the design does about it.  The voxel encoder's full-resolution stage (five
convolutions per image) runs through them.

``conv3x3x3(x, w)``: x (B, Ci, D, H, W) f32, w torch layout
(Co, Ci, 3, 3, 3) f32 -> (B, Co, D, H, W) f32, differentiable through
``Conv3x3x3Fn``, the counterpart of the JAX package's custom VJP
(``_make_conv``): dx is K2 on the upstream gradient with the weights
flipped on the three spatial axes and Ci/Co swapped, dk is K3, and the bias
gradient stays with the caller's bias add.  CPU tensors take the plain
versions (shift-and-add forms); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from list_tpu_torch.device import H100_SXM
from list_tpu_torch.ops.cuda import build

SOURCE = 'list_tpu_torch/csrc/stencil3d.cu'
REPLACES = 'list_tpu/ops/pallas/stencil3d.py:138'
DK_SOURCE = 'list_tpu_torch/csrc/conv3x3x3_dk.cu'
DK_REPLACES = 'list_tpu/ops/pallas/stencil3d.py:164'
# Kernel launches since the last reset (launches only, never plain calls):
# ``launches`` counts every K2 launch, ``dx_launches`` the K2 launches made
# for a backward's dx (a subset of ``launches``), ``dk_launches`` K3.
launches = 0
dx_launches = 0
dk_launches = 0
# pass-1 blocks of K3 (each writes one row of Co*Ci*27 partial sums)
DK_BLOCKS = 1024


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shift-and-add reference: 27 shifted slices, each contracted over Ci
    (in the input's dtype)."""
    B, Ci, D, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    out = x.new_zeros(B, w.shape[0], D, H, W)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                sl = xp[:, :, dz:dz + D, dy:dy + H, dx:dx + W]
                out += torch.einsum('oi,bidhw->bodhw', w[:, :, dz, dy, dx],
                                    sl)
    return out


def conv3x3x3_dk_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Transpose of the shift-and-add form: x (B, Ci, D, H, W), upstream
    gradient g (B, Co, D, H, W) -> dk (Co, Ci, 3, 3, 3), one contraction
    over (b, d, h, w) per tap (in the input's dtype)."""
    B, Ci, D, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    dk = x.new_empty(g.shape[1], Ci, 3, 3, 3)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                sl = xp[:, :, dz:dz + D, dy:dy + H, dx:dx + W]
                dk[:, :, dz, dy, dx] = torch.einsum('bodhw,bidhw->oi', g, sl)
    return dk


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f'conv3x3x3 takes float32, got {x.dtype}/{w.dtype}')
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f'conv3x3x3 shapes: x {tuple(x.shape)}, '
                         f'w {tuple(w.shape)}')
    if w.shape[1] != x.shape[1]:
        raise ValueError('conv3x3x3: weight Ci does not match input')
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError('conv3x3x3 takes contiguous tensors')
    if w.device != x.device:
        raise ValueError('conv3x3x3: x and w on different devices')
    co, ci = w.shape[0], w.shape[1]
    co_pad = 1 if co == 1 else -(-co // 4) * 4
    if co > 16 or ci * 27 * co_pad * 4 > 48 * 1024:
        raise ValueError(f'conv3x3x3 kernel takes Co <= 16 and a weight '
                         f'block <= 48 KB, got Ci={ci}, Co={co}')
    B, _, D, H, W = x.shape
    # one block per (b, z, TY rows, 128 columns); TY as csrc/stencil3d.cu
    ty = 8 * (1 if co_pad >= 12 else 2 if co_pad == 8 else 4)
    if B * D * -(-H // ty) * -(-W // 128) > 2 ** 31 - 1:
        raise ValueError('conv3x3x3 kernel takes at most 2^31 - 1 tiles')


def _launch(x: torch.Tensor, w: torch.Tensor, dx: bool = False
            ) -> torch.Tensor:
    """K2 on a CUDA tensor (``dx``: the launch is a backward's dx)."""
    global launches, dx_launches
    _check(x, w)
    B, Ci, D, H, W = x.shape
    Co = w.shape[0]
    y = torch.empty(B, Co, D, H, W, dtype=torch.float32, device=x.device)
    lib = build.load('stencil3d')
    fn = lib.conv3x3x3_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, Ci, Co, D, H, W,
            build.stream_handle(x.device))
    build.check(rc, 'conv3x3x3')
    launches += 1
    dx_launches += int(dx)
    return y


def _conv(x: torch.Tensor, w: torch.Tensor, dx: bool = False
          ) -> torch.Tensor:
    if x.device.type == 'cpu':
        return conv3x3x3_plain(x, w)
    return _launch(x, w, dx)


def conv3x3x3_dk(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dk (Co, Ci, 3, 3, 3) of ``conv3x3x3`` for input x and upstream
    gradient g: K3 on a CUDA tensor, the plain version on a CPU tensor."""
    global dk_launches
    if x.device.type == 'cpu':
        return conv3x3x3_dk_plain(x, g)
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f'conv3x3x3_dk takes float32, got '
                        f'{x.dtype}/{g.dtype}')
    if x.dim() != 5 or g.dim() != 5 or x.shape[0] != g.shape[0] \
            or x.shape[2:] != g.shape[2:]:
        raise ValueError(f'conv3x3x3_dk shapes: x {tuple(x.shape)}, '
                         f'g {tuple(g.shape)}')
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError('conv3x3x3_dk takes contiguous tensors')
    if g.device != x.device:
        raise ValueError('conv3x3x3_dk: x and g on different devices')
    B, Ci, D, H, W = x.shape
    Co = g.shape[1]
    if Ci > 16 or Co > 16:
        raise ValueError(f'conv3x3x3_dk kernel takes Ci, Co <= 16, got '
                         f'Ci={Ci}, Co={Co}')
    nblk = min(B * D * H, DK_BLOCKS)
    dk = torch.empty(Co, Ci, 3, 3, 3, dtype=torch.float32, device=x.device)
    partial = torch.empty(nblk, Co * Ci * 27, dtype=torch.float32,
                          device=x.device)
    lib = build.load('conv3x3x3_dk')
    fn = lib.conv3x3x3_dk_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), g.data_ptr(), dk.data_ptr(), partial.data_ptr(),
            nblk, B, Ci, Co, D, H, W, build.stream_handle(x.device))
    build.check(rc, 'conv3x3x3_dk')
    dk_launches += 1
    return dk


class Conv3x3x3Fn(torch.autograd.Function):
    """K2 forward; backward dx by K2 (only when the input needs a
    gradient: the first convolution's input, the occupancy grid, does not)
    and dk by K3."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _conv(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, w.flip(2, 3, 4).transpose(0, 1).contiguous(),
                       dx=True)
        if ctx.needs_input_grad[1]:
            dk = conv3x3x3_dk(x, g)
        return dx, dk


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Conv3x3x3Fn.apply(x, w)


def bound_ms(x_shape, co: int, mem_gbs: float = H100_SXM['mem_gbs'],
             f32_tflops: float = H100_SXM['f32_tflops']) -> tuple:
    """(least time in ms on an H100 SXM, 'bytes' or 'operations') for one
    call of K2 or K3 on input shape ``x_shape`` with ``co`` output
    channels: both read one Ci-channel and one Co-channel volume and write
    the other operand (the weights or the output), and both do
    2*27*Ci*Co FLOP per voxel, against the memory rate and the f32 peak
    outside the tensor cores (data-sheet rates)."""
    B, Ci, D, H, W = x_shape
    vox = B * D * H * W
    byts = 4 * vox * (Ci + co) + 4 * co * Ci * 27
    flops = 2 * 27 * Ci * co * vox
    t_b = byts / (mem_gbs * 1e9) * 1e3
    t_f = flops / (f32_tflops * 1e12) * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')

