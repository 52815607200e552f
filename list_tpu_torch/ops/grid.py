"""Grid generation and point-cloud voxelization
(counterpart of ``list_tpu/ops/grid.py``).

Voxelization is nearest-grid-point quantization ``round((p - bb_min) /
step)`` with clamping, written as a scatter of ones into a zeroed
``(B, R, R, R)`` volume.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def create_grid_points_from_bounds(minimum: float, maximum: float,
                                   res: int) -> np.ndarray:
    """(res**3, 3) float64 grid points, x-major ('ij') order."""
    x = np.linspace(minimum, maximum, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    return np.column_stack((X.ravel(), Y.ravel(), Z.ravel()))


def voxel_indices(points: torch.Tensor, bb_min: float, bb_max: float,
                  res: int) -> torch.Tensor:
    """Nearest grid-point index per axis: (..., 3) int64 in [0, res-1].
    A NaN coordinate takes index 0, as the JAX package's float-to-int cast
    gives it on the CPU (torch's cast leaves it out of range, which a
    scatter on the card would trip on)."""
    step = (bb_max - bb_min) / (res - 1)
    idx = torch.round((points - bb_min) / step)
    return torch.nan_to_num(idx, nan=0.0).clamp(0, res - 1).long()


@torch.no_grad()
def voxelize(points: torch.Tensor, bb_min: float, bb_max: float, res: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Occupancy grid (B, res, res, res) from a point cloud (B, N, 3); axis
    order (x, y, z)."""
    B = points.shape[0]
    ijk = voxel_indices(points.detach(), bb_min, bb_max, res)
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    occ = torch.zeros(B, res ** 3, dtype=dtype, device=points.device)
    occ.scatter_(1, flat, 1.0)
    return occ.view(B, res, res, res)


def reorder_and_scale_query(query: torch.Tensor) -> torch.Tensor:
    """The reference's decoder query remap ``q[..., [2, 1, 0]] * 2``, as a
    flip of the last axis: a list index would upload its indices from the
    host at every call."""
    return query.flip(-1) * 2.0
