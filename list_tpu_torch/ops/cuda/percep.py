"""The dense decode's perceptual sample: the projected perceptual map at
each query's pixel, one row a query.

Replaces no TPU kernel: the JAX package leaves this sample to XLA
(``list_tpu/ops/dense_grid.py:640-689``).  On a CUDA tensor it takes the
place of the plain version's PyTorch passes (a four-corner gather of
(4n, C) rows into device memory and nine bf16 passes over (n, C)).  The
CUDA source is ``csrc/percep_sample.cu``; its header states the bound on
an H100 and what the design does about it.

``percep_sample(flat_pm, t, p0, p1, p2, dt)`` -> (n, C) in ``dt``: the
projected map ``flat_pm`` (``PERCEP_MAP``^2, C) at the queries (p0, p1,
p2), each (S, R, R) f32, through the (4, 3) camera ``t``.  A CPU tensor
takes ``percep_sample_plain``; a CUDA tensor launches the kernel or
raises.  The kernel takes a bf16 or f32 map and writes ``dt``, the map's
type, with the camera and coordinates in f32 on the map's card and the
map's rows whole 16-byte vectors, 16-byte aligned (C % 8 == 0 in bf16,
C % 4 == 0 in f32; every map of the port is); an f64 decode runs on the
CPU only.  The kernel's output is contiguous and 16-byte aligned, as K1's
percep operand must be.  It computes the bilinear in f32 and, in bf16,
rounds it once, where the plain version rounds after each of its passes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from list_tpu_torch.device import H100_SXM
from list_tpu_torch.ops.cuda import build

SOURCE = 'list_tpu_torch/csrc/percep_sample.cu'
PERCEP_MAP = 137  # the perceptual maps' side after the resize
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# kernel launches since the last reset (launches only, never plain calls)
launches = 0


def pixel_coords(t: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                 p2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xpix, ypix) f32: (p0, p1, p2, 1) through the camera ``t`` with the
    perspective divide (+1e-8), clamped to the map."""
    ms = PERCEP_MAP
    u = p0 * t[0, 0] + p1 * t[1, 0] + p2 * t[2, 0] + t[3, 0]
    v = p0 * t[0, 1] + p1 * t[1, 1] + p2 * t[2, 1] + t[3, 1]
    d = p0 * t[0, 2] + p1 * t[1, 2] + p2 * t[2, 2] + t[3, 2]
    xpix = (u / (d + 1e-8)).clamp(0.0, float(ms - 1))
    ypix = (v / (d + 1e-8)).clamp(0.0, float(ms - 1))
    return xpix, ypix


def percep_sample_plain(flat_pm: torch.Tensor, t: torch.Tensor,
                        p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                        dt: torch.dtype) -> torch.Tensor:
    """The 4-corner gather and the bilinear in ``dt``, each pass rounded
    to ``dt``."""
    ms = PERCEP_MAP
    n = p0.numel()
    xpix, ypix = pixel_coords(t, p0, p1, p2)
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


def check_operands(flat_pm: torch.Tensor, t: torch.Tensor, p0: torch.Tensor,
                   p1: torch.Tensor, p2: torch.Tensor, dt: torch.dtype,
                   kernel: bool) -> None:
    """Raise on operands of the wrong shape; with ``kernel``, also on what
    the kernel does not take: a map other than bf16 or f32, ``dt`` other
    than the map's, rows that are not whole 16-byte vectors at 16-byte
    alignment, or operands off the map's card."""
    ms = PERCEP_MAP
    if flat_pm.dim() != 2 or flat_pm.shape[0] != ms * ms \
            or flat_pm.shape[1] == 0:
        raise ValueError(f'percep_sample: the map must be ({ms}^2, C), got '
                         f'{tuple(flat_pm.shape)}')
    if tuple(t.shape) != (4, 3) or t.dtype != torch.float32:
        raise ValueError(f'percep_sample: the camera must be (4, 3) f32, got '
                         f'{tuple(t.shape)} {t.dtype}')
    ps = (p0, p1, p2)
    if any(p.dim() != 3 or p.shape != p0.shape or p.dtype != torch.float32
           for p in ps) or p0.numel() == 0:
        raise ValueError('percep_sample: the coordinates must be three '
                         'non-empty (S, R, R) f32 tensors, got '
                         f'{[(tuple(p.shape), p.dtype) for p in ps]}')
    if not kernel:
        return
    if flat_pm.dtype not in KERNEL_DTYPES or dt != flat_pm.dtype:
        raise TypeError(f'percep_sample kernel takes a bf16 or f32 map and '
                        f'writes its type, got {flat_pm.dtype} and {dt}')
    if (flat_pm.shape[1] * flat_pm.element_size()) % 16 \
            or not flat_pm.is_contiguous() or flat_pm.data_ptr() % 16:
        raise ValueError('percep_sample kernel takes a contiguous map of '
                         'whole 16-byte rows, 16-byte aligned, got C = '
                         f'{flat_pm.shape[1]} {flat_pm.dtype} at '
                         f'{flat_pm.data_ptr() % 16} bytes past 16')
    if any(x.device != flat_pm.device for x in (t,) + ps):
        raise ValueError('percep_sample: the camera and the coordinates '
                         'must lie on the map\'s device')


def _count() -> None:
    global launches
    with build.count_lock:
        launches += 1


def percep_sample(flat_pm: torch.Tensor, t: torch.Tensor, p0: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor, dt: torch.dtype
                  ) -> torch.Tensor:
    """(n, C) in ``dt``, n = p0.numel() (module docstring)."""
    kernel = flat_pm.device.type != 'cpu'
    check_operands(flat_pm, t, p0, p1, p2, dt, kernel)
    if not kernel:
        return percep_sample_plain(flat_pm, t, p0, p1, p2, dt)
    t = t.contiguous()
    n, C = p0.numel(), flat_pm.shape[1]
    out = torch.empty((n, C), dtype=dt, device=flat_pm.device)
    fn = build.load('percep_sample').percep_sample
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int] \
        + [ctypes.c_longlong] * 11 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = [s for p in (p0, p1, p2) for s in p.stride()]
    build.launch(flat_pm.device, 'percep_sample', fn, flat_pm.data_ptr(),
                 t.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                 out.data_ptr(), n, C, PERCEP_MAP, p0.shape[1], p0.shape[2],
                 *strides, int(dt == torch.float32))
    _count()
    return out


def bound_ms(n: int, C: int, elem: int = 2,
             mem_gbs: float = H100_SXM['mem_gbs']) -> float:
    """Least time in ms on an H100 SXM of one call at n queries and C
    channels of ``elem`` bytes (2: bf16): the (n, C) output written and the
    (PERCEP_MAP^2, C) map read once (data-sheet memory rate)."""
    nbytes = elem * C * (n + PERCEP_MAP * PERCEP_MAP)
    return nbytes / (mem_gbs * 1e9) * 1e3
