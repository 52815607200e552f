"""Camera/pixel projection helpers (reference: network/net_util.py:5-89,
utils.py:113-137), the counterpart of ``list_tpu/ops/projection.py`` on
tensors.

These are the generic world->camera->pixel utilities; the shipped LIST
configs use the learned spatial-transformer projection inside
PerceptualPooling, but the helpers are part of the public surface (used by
camera-supervised variants / --supervise_proj experiments).
"""

from __future__ import annotations

from typing import Tuple

import torch


def transform_points(points: torch.Tensor, transmat: torch.Tensor
                     ) -> torch.Tensor:
    """Homogeneous transform: (B, N, 3) x (B, 4, 3or4) -> (B, N, k)."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    homo = torch.cat([points, ones], dim=-1)
    return torch.einsum('bnk,bkj->bnj', homo, transmat)


def project_points_to_pixels(homopoints: torch.Tensor, img_res: int = 224
                             ) -> torch.Tensor:
    """Perspective divide + integer pixel clamping (net_util semantics):
    (B, N, 3) -> (B, N, 2) int32 pixels in [0, img_res-1]; the cast
    truncates toward zero, as ``astype(int32)`` does."""
    xy = homopoints[..., :2] / homopoints[..., 2:3]
    pixels = xy.to(torch.int32)
    return torch.clamp(pixels, 0, img_res - 1)


def project_points_to_uv(homopoints: torch.Tensor, img_res: int = 224
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized uv in [-1, 1] plus depth."""
    xy = homopoints[..., :2] / homopoints[..., 2:3]
    uv = xy * 2.0 / img_res - 1.0
    return uv, homopoints[..., 2]


def check_points(points: torch.Tensor, img_res: int) -> torch.Tensor:
    """Clamp integer pixel coords into the image (reference utils.py:63-69)."""
    return torch.clamp(points, 0, img_res - 1)


def sample_features_by_pixels(featmap: torch.Tensor, pixels: torch.Tensor
                              ) -> torch.Tensor:
    """Nearest-pixel feature lookup: featmap (B, H, W, C), pixels (B, N, 2)
    int (x, y) -> (B, N, C) (net_util index_select equivalent)."""
    b, h, w, c = featmap.shape
    flat = featmap.reshape(b, h * w, c)
    idx = (pixels[..., 1] * w + pixels[..., 0]).long()
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
