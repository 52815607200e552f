"""The comparisons that decide ``correct``.

Training (``train_readings``): the program's first three steps against the
reference's from the same weights and batches.

- ``loss_gap``: the largest relative gap of a loss term over the steps.
- ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient as the optimizer gets it (Adam's first moment after one step,
  over 1 - beta1), against the reference leaf's norm or the median leaf's,
  whichever is larger.
- ``step_gap``: the same for the norm of each leaf's change after three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf under that moves by round-off
  alone, as a linear layer's bias in front of a BatchNorm does).
- ``loss_gap_first`` and ``step_gap_median``: the first step's loss gap
  and the median leaf's change gap, steadier readings of the same.
- ``grad_gap_median`` (``median_grad_gap``, read by the cells over
  several ranks): the median leaf's first-gradient gap.

Meshes (``mesh_readings``): an answer is the host grid that came over the
wire and the mesh's vertices, against the reference's grid of the same
image.

- ``grid_gap``: the largest gap on the cells whose values the answer
  carries (the corners of cubes holding both classes), over the
  reference grid's standard deviation.
- ``class_flip``: the cells whose class (inside or outside) differs,
  over the reference's count of such corner cells.
- ``vertex_gap``: the mean distance from each vertex to the nearest of
  the other side's, the larger of the two directions, in voxels.  The
  reference's vertices are its grid's edge crossings, interpolated
  linearly, placed in the mesh's frame: the scalar normalization of
  ``generate_mesh`` (by the smallest and largest coordinate) taken from
  the crossings of the answer's own grid.  In each side's own frame one
  extreme vertex that rounding moves rescales the whole mesh, and a mean
  gap of 0.12-0.19 voxels reads 0.46-1.48 on some seeds (PERF.md).

``grid_gap`` is read, not compared: its largest gap falls on the few
band cells at the box's faces, where the fitted field is 3-7 standard
deviations from 0 and both precisions' rounding is of one size, and the
control reads it under three times the program (PERF.md).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
from scipy.spatial import cKDTree

GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def worst_leaves(prog: Dict, ref: Dict, k: int = 3) -> Dict[str, list]:
    """The leaves of the largest gradient and change gaps, for the look."""
    names = sorted(ref['grad'])
    g = _leaf_gaps(prog['grad'], ref['grad'], names)
    c = _leaf_gaps(prog['change'], ref['change'], _moved(ref))
    return {'grad': sorted(g.items(), key=lambda x: -x[1])[:k],
            'change': sorted(c.items(), key=lambda x: -x[1])[:k]}


def _moved(ref: Dict) -> List[str]:
    names = sorted(ref['grad'])
    med = statistics.median(ref['grad'][n] for n in names)
    return [n for n in names if ref['grad'][n] >= GRAD_FLOOR * med]


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {'losses': [3 x {key: value}], 'grad': {leaf:
    norm}, 'change': {leaf: norm}}."""
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
               for p, r in zip(prog['losses'], ref['losses']) for k in r)
    moved = _moved(ref)
    first = max(abs(prog['losses'][0][k] - v) / max(abs(v), 1e-30)
                for k, v in ref['losses'][0].items())
    grad = _leaf_gaps(prog['grad'], ref['grad'], sorted(ref['grad']))
    change = _leaf_gaps(prog['change'], ref['change'], moved)
    return dict(loss_gap=loss, loss_gap_first=first,
                grad_gap=max(grad.values()), step_gap=max(change.values()),
                step_gap_median=statistics.median(change.values()))


def median_grad_gap(prog: Dict, ref: Dict) -> float:
    names = sorted(ref['grad'])
    return statistics.median(
        _leaf_gaps(prog['grad'], ref['grad'], names).values())


def mixed_cube_mask(pos: np.ndarray) -> np.ndarray:
    """Cells at a corner of a 2^3 cube that holds both classes."""
    R = pos.shape[0]
    c0 = pos[:-1, :-1, :-1]
    mixed = np.zeros_like(c0)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                mixed |= pos[dx:dx + R - 1, dy:dy + R - 1, dz:dz + R - 1] != c0
    mask = np.zeros_like(pos)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                mask[dx:dx + R - 1, dy:dy + R - 1, dz:dz + R - 1] |= mixed
    return mask


def crossing_vertices(grid: np.ndarray) -> np.ndarray:
    """(V, 3) points, in grid-index units, where the grid crosses 0 along
    each edge between neighbouring cells, linearly interpolated."""
    out = []
    inside = grid < 0
    for ax in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[ax], b[ax] = slice(0, -1), slice(1, None)
        g0, g1 = grid[tuple(a)], grid[tuple(b)]
        cross = inside[tuple(a)] != inside[tuple(b)]
        idx = np.argwhere(cross).astype(np.float64)
        v0 = g0[cross].astype(np.float64)
        v1 = g1[cross].astype(np.float64)
        idx[:, ax] += v0 / (v0 - v1)
        out.append(idx)
    return np.concatenate(out)


def frame(v: np.ndarray):
    """(lo, hi) of the scalar normalization that ``generate_mesh`` gives
    vertices ``v`` (grid-index units): their smallest and largest
    coordinate; None for 10 vertices or fewer, which it leaves as they
    are."""
    return (float(v.min()), float(v.max())) if len(v) > 10 else None


def place(v: np.ndarray, fr, bb_min: float, bb_max: float):
    """(vertices ``v`` placed in the frame ``fr``, one voxel in those
    units)."""
    if fr is None:
        return v, 1.0
    lo, hi = fr
    return (v - lo) / hi * (bb_max - bb_min) + bb_min, (bb_max - bb_min) / hi


def place_vertices(v: np.ndarray, bb_min: float, bb_max: float):
    """Vertices placed as the mesh places them, in their own frame."""
    return place(v, frame(v), bb_min, bb_max)


def mesh_readings(grid: np.ndarray, verts: np.ndarray, ref: np.ndarray,
                  bb_min: float, bb_max: float) -> Dict[str, float]:
    """One answer (host grid, mesh vertices) against the reference grid
    (all in the wire's units: raw SDF over sdf_scale)."""
    scale = float(ref.std()) or 1.0
    pos, ref_pos = grid > 0, ref > 0
    band = mixed_cube_mask(pos)
    gap = float(np.abs(grid[band] - ref[band]).max()) / scale \
        if band.any() else 0.0
    ref_band = int(mixed_cube_mask(ref_pos).sum())
    flip = float(np.count_nonzero(pos != ref_pos)) / max(ref_band, 1)
    rv, voxel = place(crossing_vertices(ref), frame(crossing_vertices(grid)),
                      bb_min, bb_max)
    if len(verts) == 0 or len(rv) == 0:
        vgap = 0.0 if len(verts) == len(rv) else float('inf')
    else:
        d1 = cKDTree(rv).query(verts)[0].mean()
        d2 = cKDTree(verts).query(rv)[0].mean()
        vgap = float(max(d1, d2)) / voxel
    return dict(grid_gap=gap, class_flip=flip, vertex_gap=vgap)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}

