"""DISN, the Deep Implicit Surface Network (Xu, Wang, Chen, Mech, Neumann,
NeurIPS 2019, arXiv:1905.10711; github.com/Xharlie/DISN), with a known
camera.

- ``encoder``: VGG-16 (``models/vgg.py``): the global feature (fc8) and
  the five maps ``conv1_2`` ... ``conv5_3``.
- The local feature of a query: the five maps resized to 137^2 (align
  corners), the query projected through the image's (4, 3) camera with a
  perspective divide and sampled bilinearly (``PerceptualPooling``).
- Two streams, each a point MLP of the query's xyz (ReLU after every
  layer) and a head over ``[point feature | image feature]`` (ReLU
  between layers, none after the last): ``stream_g`` on the global
  feature, ``stream_l`` on the local one.  The SDF is their sum (raw,
  ``sdf_scale`` units).

The camera-estimation network of the paper is a model of its own, trained
apart; here the camera is an input (the paper's ground-truth-camera
setting): a per-image ``trans_mat`` (B, 4, 3), or the configuration's
``disn_camera``.  ``encode`` runs the image work once; ``decode`` is the
per-query decoder (training, and the reference's order of work);
``ops/dense_grid.py`` ``disn_grid_sdf`` is the dense grid's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from list_tpu_torch.models.percep import PerceptualPooling
from list_tpu_torch.models.vgg import POOL, VGG16
from list_tpu_torch.ops.consts import device_const

class Stream(nn.Module):
    """A point MLP 3 -> point[0] -> ... -> point[-1] and a head over
    ``[point feature | feat_dim image channels]`` -> head[0] -> ... -> 1."""

    def __init__(self, feat_dim: int, point: Sequence[int],
                 head: Sequence[int]):
        super().__init__()
        dims = (3,) + tuple(point)
        for i, (a, o) in enumerate(zip(dims, dims[1:])):
            setattr(self, f'point{i + 1}', nn.Linear(a, o))
        hd = (dims[-1] + feat_dim,) + tuple(head)
        for i, (a, o) in enumerate(zip(hd, hd[1:])):
            setattr(self, f'fc{i + 1}', nn.Linear(a, o))
        self.fc_out = nn.Linear(hd[-1], 1)
        self.n_point, self.n_head = len(point), len(head)

    def points(self, q: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_point):
            q = F.relu(getattr(self, f'point{i + 1}')(q))
        return q

    def forward(self, q: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """q (B, N, 3), feat (B, N, feat_dim) -> (B, N)."""
        x = torch.cat([self.points(q), feat], -1)
        for i in range(self.n_head):
            x = F.relu(getattr(self, f'fc{i + 1}')(x))
        return self.fc_out(x)[..., 0]


class DISN(nn.Module):
    def __init__(self, vgg_widths: Sequence[int], vgg_fc: Sequence[int],
                 point: Sequence[int], head: Sequence[int],
                 camera: Sequence[float], map_size: int = 137):
        super().__init__()
        self.camera = tuple(float(c) for c in camera)
        self.encoder = VGG16(vgg_widths, vgg_fc, POOL)
        self.percep_pooling = PerceptualPooling(map_size)
        self.stream_g = Stream(vgg_fc[-1], point, head)
        self.stream_l = Stream(sum(vgg_widths), point, head)

    @classmethod
    def from_config(cls, config) -> 'DISN':
        return cls(vgg_widths=tuple(config.vgg_widths),
                   vgg_fc=tuple(config.vgg_fc),
                   point=tuple(config.disn_point),
                   head=tuple(config.disn_head),
                   camera=tuple(config.disn_camera))

    def camera_for(self, img: torch.Tensor) -> torch.Tensor:
        """The configuration's camera for each image, (B, 4, 3), kept on
        the device."""
        cam = device_const(('disn_camera', self.camera),
                           lambda: np.asarray(self.camera, np.float32),
                           img.device, img.dtype)
        return cam.view(1, 4, 3).expand(img.shape[0], 4, 3)

    def encode(self, img: torch.Tensor,
               trans_mat: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """img (B, H, W, 3) -> {'global' (B, G), 'feat_l2' [channels-last
        maps], 'trans_mat' (B, 4, 3)}."""
        glob, maps = self.encoder(img)
        if trans_mat is None:
            trans_mat = self.camera_for(img)
        return {'global': glob, 'feat_l2': maps, 'trans_mat': trans_mat}

    def decode(self, query: torch.Tensor, enc: Dict[str, Any],
               trans_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, N, 3) world coordinates -> (B, N) raw SDF; a given
        ``trans_mat`` replaces the encoding's camera."""
        tm = enc['trans_mat'] if trans_mat is None else trans_mat
        local = self.percep_pooling(enc['feat_l2'], query, tm)
        glob = enc['global'][:, None].expand(-1, query.shape[1], -1)
        return self.stream_g(query, glob) + self.stream_l(query, local)

    def forward(self, img: torch.Tensor, query: torch.Tensor,
                trans_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(query, self.encode(img, trans_mat))
