"""Farthest point sampling in plain PyTorch (counterpart of
``list_tpu/ops/fps.py``).

Replacement for ``pytorch3d.ops.sample_farthest_points`` (reference:
preprocessing/farthest_pointcloud.py:22), used by the offline FPS
preprocessing (``data/preprocess.py::run_fps``).  Iterative argmax of the
running minimum squared distance, on the tensor's own device: a chain of
``k - 1`` dependent steps of a dozen elementwise launches each.  The loop
never reads a value back to the host (the chosen index stays a 0-d device
tensor), so on a card the launches queue without a sync.

The squared distance is the JAX function's as XLA's CPU backend compiles
it: ``x*x`` rounded to f32, then two fused multiply-adds,
``fma(z, z, fma(y, y, x*x))``.  Each fma is computed in f64 (the square of
an f32 is exact there) and rounded back to f32, in separate launches, so
the result is the same on the CPU and on a card and the indices follow the
JAX package's at the published shape (N = 50,000, k = 5,000).  Only a sum
whose f64 rounding lands on an f32 tie could round differently from a
true fma.
"""

from __future__ import annotations

import torch


def farthest_point_sampling(points: torch.Tensor, k: int,
                            start_idx: int = 0) -> torch.Tensor:
    """Select ``k`` farthest points. points: (N, 3) f32 -> indices (k,)
    int64.

    Deterministic: starts from ``start_idx`` (pytorch3d uses a random start
    unless given; pinned for reproducibility), and a tie goes to the first
    index, as ``jnp.argmax`` does.
    """
    n = points.shape[0]
    cols = points.t().contiguous()  # (3, N): one row per coordinate
    min_d2 = torch.full((n,), float('inf'), dtype=points.dtype,
                        device=points.device)
    idxs = torch.empty((k,), dtype=torch.int64, device=points.device)
    idxs[0] = start_idx
    last = cols[:, start_idx:start_idx + 1]
    for i in range(1, k):
        d = cols - last
        d64 = d.double()
        d2 = d[0] * d[0]
        d2 = torch.addcmul(d2.double(), d64[1], d64[1]).to(points.dtype)
        d2 = torch.addcmul(d2.double(), d64[2], d64[2]).to(points.dtype)
        torch.minimum(min_d2, d2, out=min_d2)
        j = torch.argmax(min_d2)
        idxs[i] = j
        last = cols.index_select(1, j.view(1))
    return idxs


def sample_farthest_points(points: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 3) -> (k, 3) farthest point subset."""
    return points[farthest_point_sampling(points, k)]
