"""Per-point MLP 3 -> 64 -> 256 -> 512 with BatchNorm + ReLU per block
(counterpart of ``list_tpu/models/pointmlp.py``).  Channels-last
(B, N, C); BatchNorm reduces over (batch, points)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from list_tpu_torch.models.norm import BatchNorm


class PointMLP(nn.Module):
    def __init__(self, features=(64, 256, 512), in_dim: int = 3):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            lin = nn.Linear(in_dim, f)
            nn.init.xavier_normal_(lin.weight)
            nn.init.zeros_(lin.bias)
            setattr(self, f'block{i + 1}_conv', lin)
            setattr(self, f'block{i + 1}_bn',
                    BatchNorm(f))
            in_dim = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = getattr(self, f'block{i}_conv')(x)
            shp = x.shape
            x = getattr(self, f'block{i}_bn')(x.reshape(-1, shp[-1]))
            x = F.relu(x).reshape(shp)
        return x
