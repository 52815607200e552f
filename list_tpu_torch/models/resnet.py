"""ResNet18 image encoder with the stride-1 7x7 ``conv1``
(counterpart of ``list_tpu/models/resnet.py``).

Runs NCHW inside; ``forward`` takes the JAX layout (B, H, W, 3) and returns
the 128-d feature vector plus the 5-level pyramid channels-last
[feat0, layer1, layer2, layer3, layer4].  Submodule names follow the flax
tree so ``bridge.py`` maps weights by name.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from list_tpu_torch.models.norm import BatchNorm


class BasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn (+ downsample) -> relu."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters)
        self.has_down = stride != 1 or in_ch != filters
        if self.has_down:
            self.downsample_conv = nn.Conv2d(in_ch, filters, 1, stride,
                                             bias=False)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_down else x)
        return F.relu(out + identity)


class ResEncoder(nn.Module):
    def __init__(self, filters: Sequence[int] = (64, 64, 128, 256, 512),
                 fc_dim: int = 1000, out_dim: int = 128):
        super().__init__()
        f = tuple(filters)
        self.conv1 = nn.Conv2d(3, f[0], 7, 1, 3, bias=False)
        self.bn1 = BatchNorm(f[0])
        in_ch = f[0]
        for li, stride in zip(range(1, 5), (1, 2, 2, 2)):
            setattr(self, f'layer{li}_0', BasicBlock(in_ch, f[li], stride))
            setattr(self, f'layer{li}_1', BasicBlock(f[li], f[li], 1))
            in_ch = f[li]
        self.fc = nn.Linear(f[4], fc_dim)
        self.fc1 = nn.Linear(fc_dim, out_dim)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = x.permute(0, 3, 1, 2)
        feat0 = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(feat0, 3, 2, 1)
        feats = [feat0]
        for li in range(1, 5):
            h = getattr(self, f'layer{li}_1')(getattr(self, f'layer{li}_0')(h))
            feats.append(h)
        v = self.fc1(self.fc(h.mean(dim=(2, 3))))
        return v, [f.permute(0, 2, 3, 1) for f in feats]
