"""Bilinear/trilinear sampling and align-corners resizing, channels-last
(counterpart of the plain part of ``list_tpu/ops/sampling.py``).

The index and weight math mirrors the JAX package line for line (which
itself reproduces ``F.grid_sample`` / ``F.interpolate``), so both packages
round the same way: ``grid[..., 0]`` indexes the last spatial axis, and
``align_corners=True`` unnormalizes as ``(x + 1) / 2 * (size - 1)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from list_tpu_torch.ops.consts import device_const


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _corner_weights(ix, size: int, padding_mode: str):
    """(i0, i1, w1, mask0, mask1) for 1-D linear interpolation; indices are
    clamped gather-safe, masks zero out-of-range corners for 'zeros'."""
    if padding_mode == 'border':
        ix = ix.clamp(0.0, size - 1)
    i0f = torch.floor(ix)
    w1 = ix - i0f
    i0 = i0f.long()
    i1 = i0 + 1
    if padding_mode == 'zeros':
        mask0 = (i0 >= 0) & (i0 <= size - 1)
        mask1 = (i1 >= 0) & (i1 <= size - 1)
    else:
        mask0 = mask1 = None
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w1, mask0, mask1


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor, *,
                   padding_mode: str = 'zeros',
                   align_corners: bool = True) -> torch.Tensor:
    """image (B, H, W, C), grid (B, N, 2) -> (B, N, C)."""
    B, H, W, C = image.shape
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    x0, x1, wx, mx0, mx1 = _corner_weights(x, W, padding_mode)
    y0, y1, wy, my0, my1 = _corner_weights(y, H, padding_mode)
    flat = image.reshape(B, H * W, C)

    def take(yi, xi):
        idx = (yi * W + xi).unsqueeze(-1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    v00, v01 = take(y0, x0), take(y0, x1)
    v10, v11 = take(y1, x0), take(y1, x1)
    if padding_mode == 'zeros':
        v00 = v00 * (my0 & mx0)[..., None]
        v01 = v01 * (my0 & mx1)[..., None]
        v10 = v10 * (my1 & mx0)[..., None]
        v11 = v11 * (my1 & mx1)[..., None]
    wx = wx[..., None]
    wy = wy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def grid_sample_3d(volume: torch.Tensor, grid: torch.Tensor, *,
                   padding_mode: str = 'border',
                   align_corners: bool = True) -> torch.Tensor:
    """volume (B, D, H, W, C), grid (B, N, 3) -> (B, N, C)."""
    B, D, H, W, C = volume.shape
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    z = _unnormalize(grid[..., 2], D, align_corners)
    x0, x1, wx, mx0, mx1 = _corner_weights(x, W, padding_mode)
    y0, y1, wy, my0, my1 = _corner_weights(y, H, padding_mode)
    z0, z1, wz, mz0, mz1 = _corner_weights(z, D, padding_mode)
    flat = volume.reshape(B, D * H * W, C)

    def gather(zi, yi, xi):
        idx = ((zi * H + yi) * W + xi).unsqueeze(-1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    def mask(vals, mz, my, mx):
        if padding_mode == 'zeros':
            return vals * (mz & my & mx)[..., None]
        return vals

    wx = wx[..., None]
    wy = wy[..., None]
    wz = wz[..., None]

    def plane(zi, mz):
        v00 = mask(gather(zi, y0, x0), mz, my0, mx0)
        v01 = mask(gather(zi, y0, x1), mz, my0, mx1)
        v10 = mask(gather(zi, y1, x0), mz, my1, mx0)
        v11 = mask(gather(zi, y1, x1), mz, my1, mx1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    front = plane(z0, mz0)
    back = plane(z1, mz1)
    return front * (1 - wz) + back * wz


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int,
                   dtype_name: str = 'float32') -> np.ndarray:
    """(out_size, in_size) linear-interpolation matrix, align_corners=True,
    built in float64 and cast to ``dtype_name``."""
    if out_size == 1:
        m = np.zeros((1, in_size))
        m[0, 0] = 1.0
        return m.astype(dtype_name)
    pos = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w1 = pos - i0
    m = np.zeros((out_size, in_size))
    np.add.at(m, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(m, (np.arange(out_size), i1), w1)
    return m.astype(dtype_name)


def resize_bilinear_align_corners(image: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=True)`` on (B, H, W, C)
    as two interpolation-matrix products in full f32 (TF32 is off, see
    ``device.py``); the matrices are rounded to the image's dtype (f32 for
    bf16 images), as the JAX package rounds them, and kept on the
    device."""
    B, H, W, C = image.shape
    if H == out_h and W == out_w:
        return image
    dt = 'float64' if image.dtype == torch.float64 else 'float32'
    mh, mw = (device_const(('resize', n_in, n_out, dt),
                           lambda: _resize_matrix(n_in, n_out, dt),
                           image.device, image.dtype)
              for n_in, n_out in ((H, out_h), (W, out_w)))
    out = torch.einsum('oh,bhwc->bowc', mh, image)
    return torch.einsum('pw,bowc->bopc', mw, out)
