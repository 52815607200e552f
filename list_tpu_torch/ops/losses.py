"""Training losses (counterpart of ``list_tpu/ops/losses.py``).

- ``sdf_loss``: scaled-SDF L2 summed over query points, averaged over the
  batch, plus the ``ignore_``-prefixed diagnostics that stay out of the
  total (``total_loss`` in ``train/executors.py``).
- ``occupancy_loss``: weighted BCE (w = 0.9, x1000) between the voxel
  encoder's sigmoid map and the occupancy target, with the log ARGUMENTS
  clamped below at 1e-8 as the JAX package does: at p == 0 or 1 exactly
  both the value and the gradient stay finite, and ``torch.maximum``
  splits the gradient at a tie as ``jnp.maximum`` does;
- ``chamfer_distance`` / ``chamfer_loss`` (stage 1): the bidirectional
  mean squared Chamfer distance from |x|^2 + |y|^2 - 2 x.y, clamped at 0,
  in full f32 (the package switches TF32 off, as the JAX package asks for
  its HIGHEST matmul precision here: the form cancels in low precision).
"""

from __future__ import annotations

from typing import Dict

import torch


def sdf_loss(pred_sdf: torch.Tensor, gt_sdf: torch.Tensor,
             sdf_scale: float) -> Dict[str, torch.Tensor]:
    """pred_sdf, gt_sdf: (B, N).  Keys containing 'ignore' are diagnostics."""
    loss = ((gt_sdf * sdf_scale - pred_sdf) ** 2).sum(-1).mean()
    realvalue = ((gt_sdf - pred_sdf / sdf_scale) ** 2).mean() * 10000.0
    accuracy = ((gt_sdf > 0.5) == (pred_sdf > 0.5)).float().mean()
    return {
        'sdf_loss': loss,
        'ignore_sdf_loss_realvalue': realvalue,
        'ignore_sdf_accuracy': accuracy,
    }


def occupancy_loss(occ_pred: torch.Tensor, occ_gt: torch.Tensor,
                   w: float = 0.9) -> torch.Tensor:
    """Weighted BCE x1000 over the full voxel grid."""
    occ_pred = occ_pred.float()
    occ_gt = occ_gt.float()
    floor = occ_pred.new_full((), 1e-8)  # filled on the device
    la = torch.log(torch.maximum(occ_pred + 1e-8, floor))
    lb = torch.log(torch.maximum(1 - occ_pred + 1e-8, floor))
    return 1000.0 * (-w * (occ_gt * la).mean()
                     - (1 - w) * ((1 - occ_gt) * lb).mean())


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (B, N, 3), y (B, M, 3) -> mean over the batch of
    mean_n min_m |x - y|^2 + mean_m min_n |x - y|^2."""
    x2 = (x * x).sum(-1)
    y2 = (y * y).sum(-1)
    xy = torch.matmul(x, y.transpose(1, 2))
    d2 = x2[:, :, None] + y2[:, None, :] - 2.0 * xy
    d2 = torch.maximum(d2, d2.new_zeros(()))
    fwd = d2.min(dim=2).values.mean(dim=1)
    bwd = d2.min(dim=1).values.mean(dim=1)
    return (fwd + bwd).mean()


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CoarseNet's training loss: the Chamfer distance x 1000."""
    return chamfer_distance(pred, gt) * 1000.0
