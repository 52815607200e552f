"""VGG-16 image encoder of DISN (Xu et al. 2019; the TF-slim ``vgg_16``
its code builds).

Five blocks of 3x3 SAME convolutions with ReLU and no BatchNorm (2, 2, 3,
3, 3 convolutions of ``widths`` channels), each but the last followed by
a 2x2 max pooling of stride 2 (floor); after the last block's pooling an
adaptive average pooling to ``pool`` x ``pool`` and the classifier fc6 ->
ReLU -> fc7 -> ReLU -> fc8, whose output (no activation) is the global
feature.  Runs NCHW inside; ``forward`` takes the JAX layout (B, H, W, 3)
and returns the global feature and the five blocks' last maps
(``conv1_2`` ... ``conv5_3``) channels-last, the perceptual pyramid.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BLOCK_CONVS = (2, 2, 3, 3, 3)
POOL = 7


def conv_names() -> List[Tuple[int, str]]:
    """(block, name) of every convolution, in order."""
    return [(b, f'conv{b + 1}_{i + 1}') for b, n in enumerate(BLOCK_CONVS)
            for i in range(n)]


class VGG16(nn.Module):
    def __init__(self, widths: Sequence[int], fc: Sequence[int],
                 pool: int = POOL):
        super().__init__()
        self.widths, self.pool = tuple(widths), pool
        c_in = 3
        for b, name in conv_names():
            setattr(self, name, nn.Conv2d(c_in, self.widths[b], 3, 1, 1))
            c_in = self.widths[b]
        dims = (c_in * pool * pool,) + tuple(fc)
        for i, (a, o) in enumerate(zip(dims, dims[1:])):
            setattr(self, f'fc{6 + i}', nn.Linear(a, o))
        self.n_fc = len(fc)

    def forward(self, img: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """img (B, H, W, 3) -> (global (B, fc[-1]), [5 maps (B, H_b, W_b,
        C_b)])."""
        h, taps, block = img.permute(0, 3, 1, 2), [], 0
        for b, name in conv_names():
            if b != block:
                taps.append(h)
                h = F.max_pool2d(h, 2, 2)
                block = b
            h = F.relu(getattr(self, name)(h))
        taps.append(h)
        h = F.adaptive_avg_pool2d(F.max_pool2d(h, 2, 2), self.pool)
        h = h.flatten(1)
        for i in range(self.n_fc):
            h = getattr(self, f'fc{6 + i}')(h)
            if i < self.n_fc - 1:
                h = F.relu(h)
        return h, [t.permute(0, 2, 3, 1) for t in taps]
