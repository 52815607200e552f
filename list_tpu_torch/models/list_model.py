"""The two LIST models (counterpart of ``list_tpu/models/list_model.py``):
``CoarseNet`` (stage 1: image -> ResEncoder's 128-d feature ->
TreeGraphDecoder -> (B, 4096, 3) coarse point cloud) and ``LIST`` (stage 2).

In ``LIST``, ``encode`` runs everything query-independent once per image
and returns the JAX package's layout: ``pc`` (B, 4096, 3), ``trans_mat``
(B, 4, 3), ``occ_in`` (B, R, R, R), channels-last ``feat_l2`` (B, H, W, C)
maps and ``vox_feat`` (B, R_s, R_s, R_s, C_s) volumes, and ``occ_pred``.
``decode_sdf`` is the general gather decoder (the chunked fallback of the
executor, and the train path's decoder).

In training mode (``model.train()``), ``encode`` takes the voxel
encoder's train path (features rounded to ``vox_packed_dtype``, bfloat16
by default, as the JAX package's fold-pack casts them; ``occ_pred`` from
before the cast), under
``checkpoint`` with ``remat``, and ``forward`` splits the query axis into
``train_query_chunks`` chunks (a zero-padded ragged tail, sliced off), each
checkpointed when decode remat is on (``remat_decode`` None follows
``remat``).  With ``remat_save_samples`` 1 a checkpointed chunk keeps its
sampled voxel stack for the backward and recomputes only the perceptual
sampling and the head; 2 also keeps the perceptual samples (the JAX
package's ``save_only_these_names('decode_vox'[, 'decode_percep'])``
policy): the same step, traded for memory.  The JAX package's layout-only
training options (fold-packed, corner-collapsed or tap-minor sampling,
fused gathers, sorted queries) compute the same values; the port computes
the plain path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from list_tpu_torch.models.norm import BatchNorm, checkpoint
from list_tpu_torch.models.percep import PerceptualPooling
from list_tpu_torch.models.pointmlp import PointMLP
from list_tpu_torch.models.resnet import ResEncoder
from list_tpu_torch.models.treegcn import TreeGraphDecoder
from list_tpu_torch.models.voxel import (VoxelDecoder2, VoxelEncoder2,
                                         sample_multiscale)
from list_tpu_torch.ops.grid import reorder_and_scale_query, voxelize
from list_tpu_torch.ops.sampling import resize_bilinear_align_corners

DEFAULT_POINT_FEAT = (128, 128, 256, 256, 256, 128, 128, 3)
DEFAULT_POINT_DEGREE = (2, 2, 2, 2, 2, 2, 64)
DEFAULT_IM_ENC_LAYERS = (1, 1, 1, 1, 16, 32, 64, 128, 128)
RESNET_FILTERS = (64, 64, 128, 256, 512)


class CoarseNet(nn.Module):
    """Stage-1 coarse point-cloud predictor; submodule names follow the
    flax tree (``image_encoder``, ``point_decoder``)."""

    def __init__(self, point_feat: Sequence[int] = DEFAULT_POINT_FEAT,
                 point_degree: Sequence[int] = DEFAULT_POINT_DEGREE,
                 support: int = 10):
        super().__init__()
        self.image_encoder = ResEncoder(RESNET_FILTERS)
        self.point_decoder = TreeGraphDecoder(tuple(point_feat),
                                              tuple(point_degree), support)

    @classmethod
    def from_config(cls, config) -> 'CoarseNet':
        return cls(point_feat=tuple(config.point_feat),
                   point_degree=tuple(config.point_degree))

    def forward(self, rgba: torch.Tensor) -> torch.Tensor:
        """rgba (B, H, W, 3) -> (B, 4096, 3)."""
        featvec, _ = self.image_encoder(rgba)
        return self.point_decoder([featvec[:, None, :]])


class SpatialTransformer(nn.Module):
    """MLP 640 -> 128 -> 128 -> 12 with LeakyReLU(0.2) + BatchNorm1d,
    reshaped to a (B, 4, 3) learned camera projection."""

    def __init__(self, in_dim: int = 640):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, 128)
        self.bn0 = BatchNorm(128)
        self.fc1 = nn.Linear(128, 128)
        self.bn1 = BatchNorm(128)
        self.fc2 = nn.Linear(128, 12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn0(F.leaky_relu(self.fc0(x), 0.2))
        x = self.bn1(F.leaky_relu(self.fc1(x), 0.2))
        return self.fc2(x).reshape(-1, 4, 3)


def vox_channels(im_enc_layers: Sequence[int]) -> tuple:
    """Channels of each VoxelEncoder2 feature scale."""
    L = list(im_enc_layers)
    return tuple([L[3]] + [L[l + 1] for l in range(3, len(L) - 1)])


class LIST(nn.Module):
    def __init__(self, vox_res: int = 128, bb_min: float = -0.5,
                 bb_max: float = 0.5,
                 point_feat: Sequence[int] = DEFAULT_POINT_FEAT,
                 point_degree: Sequence[int] = DEFAULT_POINT_DEGREE,
                 im_enc_layers: Sequence[int] = DEFAULT_IM_ENC_LAYERS,
                 h_dim: int = 256, support: int = 10, remat: bool = False,
                 remat_decode: Optional[bool] = None,
                 train_query_chunks: int = 4,
                 vox_packed_dtype: Optional[str] = 'bfloat16',
                 remat_save_samples: int = 0):
        super().__init__()
        self.vox_res, self.bb_min, self.bb_max = vox_res, bb_min, bb_max
        self.remat, self.remat_decode = remat, remat_decode
        self.remat_save_samples = remat_save_samples
        self.train_query_chunks = train_query_chunks
        self.im_enc_layers = tuple(im_enc_layers)
        self.h_dim = h_dim
        self.vox_encoder = VoxelEncoder2(tuple(im_enc_layers),
                                         vox_packed_dtype)
        n_percep = sum(RESNET_FILTERS)
        in_dim = 7 * sum(vox_channels(im_enc_layers)) + n_percep + 3
        self.sdf_decoder = VoxelDecoder2(in_dim, h_dim)
        self.percep_pooling = PerceptualPooling()
        self.im_encoder = ResEncoder(RESNET_FILTERS)
        self.im_encoder2 = ResEncoder(RESNET_FILTERS)
        self.point_decoder = TreeGraphDecoder(tuple(point_feat),
                                              tuple(point_degree), support)
        self.point_mlp_coarse = PointMLP()
        self.spatial_transformer = SpatialTransformer(512 + 128)

    @classmethod
    def from_config(cls, config) -> 'LIST':
        rd = int(getattr(config, 'remat_decode', -1))
        return cls(vox_res=config.vox_res, bb_min=config.bb_min,
                   bb_max=config.bb_max, point_feat=tuple(config.point_feat),
                   point_degree=tuple(config.point_degree),
                   im_enc_layers=tuple(config.im_enc_layers),
                   remat=bool(getattr(config, 'remat', 0)),
                   remat_decode=None if rd < 0 else bool(rd),
                   remat_save_samples=int(
                       getattr(config, 'remat_save_samples', 0)),
                   train_query_chunks=int(
                       getattr(config, 'train_query_chunks', 4)))

    def encode(self, img: torch.Tensor,
               trans_mat: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """img (B, H, W, 3) -> the query-independent encoding."""
        feat_g, _ = self.im_encoder(img)
        feat_g2, feat_l2 = self.im_encoder2(img)
        pc = self.point_decoder([feat_g[:, None, :]])
        feat_coarse = self.point_mlp_coarse(pc).amax(dim=1)
        feat_coarse_im = torch.cat(
            [feat_coarse, feat_g2.reshape(img.shape[0], -1)], dim=1)
        if trans_mat is None:
            trans_mat = self.spatial_transformer(feat_coarse_im)
        occ = voxelize(pc, self.bb_min, self.bb_max, self.vox_res,
                       dtype=img.dtype)
        if not self.training:
            vox_feat = self.vox_encoder(occ)
            occ_pred = vox_feat[0][..., 0]
        elif self.remat and torch.is_grad_enabled():
            vox_feat, occ_pred = checkpoint(self.vox_encoder, occ, True)
        else:
            vox_feat, occ_pred = self.vox_encoder(occ, True)
        return {'pc': pc, 'trans_mat': trans_mat, 'occ_in': occ,
                'feat_l2': feat_l2, 'vox_feat': vox_feat,
                'occ_pred': occ_pred}

    def decode_sdf(self, query: torch.Tensor,
                   enc: Dict[str, Any]) -> torch.Tensor:
        """query (B, N, 3) world coords -> (B, N) raw SDF."""
        q = reorder_and_scale_query(query)
        percep = self.percep_pooling(enc['feat_l2'], q, enc['trans_mat'])
        return self.sdf_decoder(q, enc['vox_feat'], percep)

    def _decode_saving(self, query: torch.Tensor,
                       enc: Dict[str, Any]) -> torch.Tensor:
        """``decode_sdf`` of one checkpointed chunk under
        ``remat_save_samples``: the voxel sampling runs outside the
        checkpoint, so its stack is kept for the backward (with the
        sampler's indices and weights; its gathers are not redone), and the
        checkpoint recomputes the rest.  At level 2 the perceptual samples
        come from a checkpoint of their own, so they are kept too while
        their gathers are redone for their own backward."""
        q = reorder_and_scale_query(query)
        dec = self.sdf_decoder
        vox = sample_multiscale(enc['vox_feat'], q, dec.delta)

        def percep(q):
            return self.percep_pooling(enc['feat_l2'], q, enc['trans_mat'])

        if self.remat_save_samples >= 2:
            return checkpoint(dec.head, q, vox, checkpoint(percep, q))
        return checkpoint(lambda q, vox: dec.head(q, vox, percep(q)), q, vox)

    def forward(self, img: torch.Tensor, query: torch.Tensor,
                trans_mat: Optional[torch.Tensor] = None):
        """(occ_pred (B, R, R, R), sdf (B, N)); query (B, N, 3) world
        coordinates."""
        enc = self.encode(img, trans_mat)
        k = self.train_query_chunks
        if not (self.training and k > 1 and query.shape[1] > k):
            return enc['occ_pred'], self.decode_sdf(query, enc)
        # resize the pyramid once, so that recomputed chunks skip it
        ms = self.percep_pooling.map_size
        enc = dict(enc, feat_l2=[resize_bilinear_align_corners(f, ms, ms)
                                 for f in enc['feat_l2']])
        B, N = query.shape[:2]
        nc = -(-N // k)
        if nc * k != N:
            query = torch.cat([query, query.new_zeros(B, nc * k - N, 3)], 1)
        remat = self.remat if self.remat_decode is None else self.remat_decode
        remat = remat and torch.is_grad_enabled()
        sdf = []
        for c in range(k):
            qc = query[:, c * nc:(c + 1) * nc]
            if not remat:
                sdf.append(self.decode_sdf(qc, enc))
            elif self.remat_save_samples:
                sdf.append(self._decode_saving(qc, enc))
            else:
                sdf.append(checkpoint(self.decode_sdf, qc, enc))
        return enc['occ_pred'], torch.cat(sdf, 1)[:, :N]
