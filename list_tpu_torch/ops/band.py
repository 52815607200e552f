"""Iso-band wire codec for dense SDF grids, ``--fetch_mode band``
(counterpart of ``list_tpu/ops/band.py``; the host side is copied).

Marching cubes reads two things from the grid: the class ``grid > 0`` of
every vertex, and the exact values of the vertices of *mixed* cubes (cubes
holding both classes).  So the device packs one uint32 buffer

  [ sign bits: R^3/32 words | band values: cap packed wire words | count ]

about 0.77 MB instead of the 4.2 MB bf16 grid at 128^3, and the host
rebuilds a grid whose mesh is identical to the full grid's.

``band_encode`` runs in torch on the grid's device.  Torch has few uint32
operations, so words are computed in int64 and stored as int32 with the
same 32 bits; the host views them as uint32, and the buffer is
bit-identical to the JAX package's on the same grid.  ``band_cap``,
``_mixed_cube_mask``, ``band_decode``, ``BandGrid`` and ``fetch_grid_f32``
are the JAX package's, in numpy on the host (``_mixed_cube_mask`` takes a
numpy or a torch bool grid).

On the card a fetch does not wait behind later work: a device result of
``predict_grid(..., device_out=True)`` carries the CUDA event recorded
after its last kernel (``ready``) and its call's ``DeviceSpans``, and each
copy runs on a side stream that waits on that event alone, into pinned
host memory, synchronizing only that stream.  So a fetch worker copies
shape i while the main stream already runs shape i + 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from list_tpu_torch.utils.spans import DeviceSpans, count, span


def band_cap(n_cells: int, frac: float = 0.125) -> int:
    """Band-value capacity: ``frac`` of the grid, padded to an even count
    (bf16 values pack in uint32 pairs).  Real SDF isosurfaces occupy a few
    percent of cells (a radius-0.38 sphere at 128^3: ~4% after cube
    dilation); overflow falls back to the full-grid fetch."""
    cap = int(n_cells * frac)
    return cap + (cap % 2)


def _mixed_cube_mask(pos):
    """Vertices incident to a 2^3 cube containing both classes.

    ``pos``: (R, R, R) bool class grid, numpy or torch -- the device encode
    and the host decode derive the identical mask from the identical bits
    (only slicing and logical operations)."""
    c0 = pos[:-1, :-1, :-1]
    mixed = c0 != c0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx == dy == dz == 0:
                    continue
                c = pos[dx:dx + pos.shape[0] - 1, dy:dy + pos.shape[1] - 1,
                        dz:dz + pos.shape[2] - 1]
                mixed = mixed | (c != c0)
    mask = pos != pos
    R = pos.shape[0]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                mask[dx:dx + R - 1, dy:dy + R - 1, dz:dz + R - 1] |= mixed
    return mask


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


@torch.no_grad()
def band_encode(grid: torch.Tensor, cap: Optional[int] = None
                ) -> torch.Tensor:
    """(R, R, R) wire-dtype grid -> flat int32 band buffer on its device
    (the uint32 words' bits).

    Layout: [R^3/32 sign words | cap/pack packed values | count].  Values
    are the wire dtype's raw bits (bf16 pairs per word, f32 one per word)
    of the masked cells in flat C order; ``count`` is the total mask count
    (> cap signals overflow -> the caller fetches the full grid)."""
    R3 = grid.numel()
    if cap is None:
        cap = band_cap(R3)
    dev = grid.device
    pos = grid > 0
    mask = _mixed_cube_mask(pos)

    # sign words: 32 cells per word, bit k = cell (32*i + k)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = (pos.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)

    flat_mask = mask.reshape(-1)
    idx = torch.cumsum(flat_mask.to(torch.int32), dim=0) - 1
    count = idx[-1:] + 1
    # compact masked values into a cap-sized buffer (overflow rows and
    # unmasked rows all land in the dropped slot ``cap``)
    slot = torch.where(flat_mask & (idx < cap), idx,
                       torch.full_like(idx, cap))
    if grid.dtype == torch.bfloat16:
        raw = grid.reshape(-1).view(torch.int16).to(torch.int64) & 0xFFFF
        vals = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        vals[slot] = raw
        vals = vals[:cap]
        packed = _as_int32(vals[0::2] | (vals[1::2] << 16))
    else:
        raw = grid.reshape(-1).float().view(torch.int32)
        packed = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        packed[slot] = raw
        packed = packed[:cap]
    return torch.cat([_as_int32(bits), packed, count.to(torch.int32)])


def band_decode(buf: np.ndarray, resolution: int,
                wire_dtype: str = 'bfloat16') -> Optional[np.ndarray]:
    """Host inverse of band_encode -> (R, R, R) float32 grid whose mesh
    extraction is identical to the full-grid fetch; None on overflow
    (count > cap: the caller must fetch the full grid)."""
    buf = np.asarray(buf)
    R = resolution
    R3 = R * R * R
    nb = R3 // 32
    bits = buf[:nb]
    count = int(buf[-1])
    packed = buf[nb:-1]

    pos = ((bits[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
           & 1).astype(bool).reshape(R, R, R)
    mask = _mixed_cube_mask(pos)
    positions = np.flatnonzero(mask.reshape(-1))
    if count != len(positions):  # device/host mask drift: refuse
        raise ValueError(f'band mask mismatch: device {count} vs host '
                         f'{len(positions)}')
    if wire_dtype == 'bfloat16':
        cap = 2 * len(packed)
        if count > cap:
            return None
        u16 = np.empty(cap, np.uint32)
        u16[0::2] = packed & 0xFFFF
        u16[1::2] = packed >> 16
        vals = (u16 << 16).view(np.float32)
    else:
        cap = len(packed)
        if count > cap:
            return None
        vals = packed.view(np.float32)
    # classes exact everywhere; values exact on every interpolated vertex
    rec = np.where(pos, np.float32(1.0), np.float32(-1.0))
    rec.reshape(-1)[positions] = vals[:count]
    return rec


def mark_ready(result, spans: DeviceSpans):
    """Record the event after ``result``'s last kernel (a wire grid or a
    ``BandGrid``) and attach it and the call's ``spans`` to it."""
    result.ready = spans.mark()
    result.spans = spans
    return result


@torch.inference_mode()
def _to_host(t: torch.Tensor, ready=None) -> torch.Tensor:
    """A tensor's host copy (a CPU tensor as it is).  On the card the copy
    runs on a side stream that waits on ``ready`` (the event after which
    ``t`` is complete; without one, on the work queued so far on ``t``'s
    device), into pinned memory, and only that stream is synchronized;
    ``t`` is recorded on the stream so that the caching allocator does not
    hand its memory out before the copy has read it.  The host's wait on
    that stream (on ``ready``, then the copy) is the span ``fetch.wait``."""
    if t.device.type != 'cuda':
        return t
    side = torch.cuda.Stream(device=t.device)
    if ready is None:
        side.wait_stream(torch.cuda.current_stream(t.device))
    else:
        side.wait_event(ready)
    with torch.cuda.stream(side):
        t.record_stream(side)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
    with span('fetch.wait'):
        side.synchronize()
    return host


def band_to_numpy(band: torch.Tensor, ready=None) -> np.ndarray:
    """Device band buffer -> the host's uint32 words."""
    return _to_host(band, ready).numpy().view(np.uint32)


class BandGrid:
    """Device result of a band-mode dense predict: the packed band buffer
    plus the full wire grid (kept only as the overflow fallback: it is
    fetched only when count > cap).  ``fetch_grid_f32`` turns a BandGrid
    or a plain device or host grid into the (R, R, R) float32 host grid."""

    ready = None  # set by ``mark_ready`` on the card

    def __init__(self, band_buf, grid, resolution: int, wire_dtype: str):
        self.band = band_buf
        self.grid = grid
        self.resolution = resolution
        self.wire_dtype = wire_dtype

    def to_numpy(self) -> np.ndarray:
        """The host grid; counts ``band.fetches``, and ``band.fallbacks``
        when the band overflowed and the full grid is fetched."""
        count('band.fetches')
        rec = band_decode(band_to_numpy(self.band, self.ready),
                          self.resolution, self.wire_dtype)
        if rec is None:  # band overflow: full fetch (correct, just slower)
            count('band.fallbacks')
            return _grid_f32(self.grid, self.ready)
        return rec


def _grid_f32(grid: torch.Tensor, ready=None) -> np.ndarray:
    """The wire grid in f32 on the host: copied in the wire dtype,
    upcast there (exact)."""
    return _to_host(grid, ready).float().numpy()


def fetch_grid_f32(pred_values) -> np.ndarray:
    """Device -> host fetch + f32 upcast for any dense-predict result
    (BandGrid, tensor or array); the one place the sweep's fetch workers
    call.  A result with events also resolves its call's times when that
    call's last decode is done.  The fetch is the span ``request.fetch``,
    a child of the result's ``request_span`` (its call's
    ``request.launch``) where it has one."""
    with span('request.fetch',
              parent=getattr(pred_values, 'request_span', None)):
        if isinstance(pred_values, BandGrid):
            out = pred_values.to_numpy()
        elif isinstance(pred_values, torch.Tensor):
            out = _grid_f32(pred_values, getattr(pred_values, 'ready', None))
        else:
            return np.asarray(pred_values).astype(np.float32)
    spans = getattr(pred_values, 'spans', None)
    if spans is not None:
        spans.resolve(wait=False)
    return out
