"""3D voxel encoder and SDF decoder head
(counterpart of ``list_tpu/models/voxel.py``).

VoxelEncoder2, layer spec [1,1,1,1,16,32,64,128,128]:
- l<2:  conv3x3x3 + ReLU + BN
- l==2: conv + sigmoid -> features[0] (also the refined occupancy)
- l>2:  conv + ReLU, conv + ReLU, BN, collect feature, maxpool(2)

Runs NCDHW.  The full-resolution stage (every conv before the first
maxpool: five per image at the default spec) goes through the K2 kernel
wrapper ``conv3x3x3`` at any resolution (its backward through K2 and
K3); the coarser stages use ``F.conv3d``, as the JAX package leaves them to
XLA.  Features are returned channels-last (B, D, H, W, C), the JAX layout.

The train path (``packed=True``) also returns the occupancy prediction,
taken from the sigmoid before any cast, and rounds every feature to
``packed_dtype`` (bfloat16 by default, None keeps the compute dtype) and
back: the value the JAX package's fold-packed training sampler reads
(``vox_packed_dtype``).  The fold layout itself is a TPU device and is not
ported; the plain ``grid_sample_3d`` samples the rounded features.

VoxelDecoder2: 7 displaced trilinear samples (border, align corners) of
every scale + perceptual features + xyz -> 3610 -> 2h -> h -> h -> 1;
``head`` is the part after the sampling (``--remat_save_samples``
checkpoints it apart from the sampled stack).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from list_tpu_torch.models.norm import BatchNorm
from list_tpu_torch.ops.consts import device_const
from list_tpu_torch.ops.cuda.stencil3d import conv3x3x3
from list_tpu_torch.ops.sampling import grid_sample_3d


class _Conv3(nn.Conv3d):
    """3x3x3 SAME conv with bias; ``full_res`` routes it through K2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, full_res: bool = False
                ) -> torch.Tensor:
        if full_res:
            y = conv3x3x3(x.contiguous(), self.weight.contiguous())
            return y + self.bias[None, :, None, None, None]
        return F.conv3d(x, self.weight, self.bias, padding=1)


class VoxelEncoder2(nn.Module):
    def __init__(self, layers: Sequence[int] = (1, 1, 1, 1, 16, 32, 64, 128,
                                                128),
                 packed_dtype: Optional[str] = 'bfloat16'):
        super().__init__()
        self.layers = L = tuple(layers)
        self.packed_dtype = packed_dtype
        for l in range(len(L) - 1):
            setattr(self, f'conv_{l}', _Conv3(L[l], L[l + 1]))
            if l < 2:
                setattr(self, f'bn_{l}', BatchNorm(L[l + 1]))
            elif l > 2:
                setattr(self, f'conv_{l}_0', _Conv3(L[l + 1], L[l + 1]))
                setattr(self, f'bn_{l}', BatchNorm(L[l + 1]))

    def forward(self, occ: torch.Tensor, packed: bool = False):
        """occ (B, R, R, R) -> channels-last features per scale; with
        ``packed`` (the train path) -> (features rounded to
        ``packed_dtype`` and back, occupancy prediction (B, R, R, R))."""
        net = occ[:, None]
        full = True  # before the first maxpool
        features = []
        L = self.layers
        for l in range(len(L) - 1):
            conv = getattr(self, f'conv_{l}')
            if l < 2:
                net = getattr(self, f'bn_{l}')(F.relu(conv(net, full)))
            elif l == 2:
                net = torch.sigmoid(conv(net, full))
                occ_pred = net[:, 0]
                features.append(net.permute(0, 2, 3, 4, 1))
            else:
                net = F.relu(conv(net, full))
                net = F.relu(getattr(self, f'conv_{l}_0')(net, full))
                net = getattr(self, f'bn_{l}')(net)
                features.append(net.permute(0, 2, 3, 4, 1))
                net = F.max_pool3d(net, 2)
                full = False
        if not packed:
            return features
        if self.packed_dtype:
            pdt = getattr(torch, self.packed_dtype)
            features = [f.to(pdt).to(f.dtype) for f in features]
        return features, occ_pred


def make_displacements(delta: float = 0.0722) -> np.ndarray:
    """(7, 3): center, then +-delta on each axis in the reference order."""
    disp = [[0.0, 0.0, 0.0]]
    for ax in range(3):
        for s in (-1.0, 1.0):
            d = [0.0, 0.0, 0.0]
            d[ax] = s * delta
            disp.append(d)
    return np.asarray(disp, np.float32)


def sample_multiscale(feat: Sequence[torch.Tensor], p: torch.Tensor,
                      delta: float = 0.0722) -> torch.Tensor:
    """feat: channels-last (B, D, H, W, C_s) volumes; p (B, N, 3) normalized
    coords -> (B, N, sum(C_s) * 7) ordered (c * 7 + d)."""
    B, N, _ = p.shape
    disp = device_const(('displacements', delta),
                        lambda: make_displacements(delta), p.device, p.dtype)
    pd = (p[:, None, :, :] + disp[None, :, None, :]).reshape(B, 7 * N, 3)
    outs = []
    for f in feat:
        s = grid_sample_3d(f, pd, padding_mode='border', align_corners=True)
        outs.append(s.reshape(B, 7, N, f.shape[-1]).permute(0, 2, 3, 1))
    return torch.cat(outs, dim=2).reshape(B, N, -1)


class VoxelDecoder2(nn.Module):
    """SDF head; returns (B, N) raw SDF (in sdf_scale units)."""

    def __init__(self, in_dim: int = 3610, h_dim: int = 256,
                 delta: float = 0.0722):
        super().__init__()
        self.delta = delta
        self.fc_0 = nn.Linear(in_dim, 2 * h_dim)
        self.fc_1 = nn.Linear(2 * h_dim, h_dim)
        self.fc_2 = nn.Linear(h_dim, h_dim)
        self.fc_out = nn.Linear(h_dim, 1)

    def forward(self, p: torch.Tensor, feat: Sequence[torch.Tensor],
                percep_feat: torch.Tensor) -> torch.Tensor:
        return self.head(p, sample_multiscale(feat, p, self.delta),
                         percep_feat)

    def head(self, p: torch.Tensor, vox: torch.Tensor,
             percep_feat: torch.Tensor) -> torch.Tensor:
        """fc_0..fc_out over the sampled voxel stack ``vox``
        (``sample_multiscale``'s output, the JAX package's ``decode_vox``),
        the perceptual features (``decode_percep``) and xyz -> (B, N)."""
        x = torch.cat([vox, percep_feat, p], dim=-1)
        for fc in (self.fc_0, self.fc_1, self.fc_2):
            x = F.relu(fc(x))
        return self.fc_out(x)[..., 0]
