"""Dense-grid SDF decode for one image
(counterpart of ``list_tpu/ops/dense_grid.py::dense_grid_sdf``).

The inference queries are the regular grid ``linspace(bb_min, bb_max, R)``,
so trilinear sampling factorizes per axis with static indices and weights
(the numpy plans below are copies of the JAX package's).  Per x-slab:

1. Voxel features (``ops/cuda/voxel.py`` ``KeptTaps``): same-resolution
   kept scales are grouped, and each group's seven displacement taps at the
   slab's queries give the structured parts ``[A5 | Ax- | Ax+]``.
2. Coarse-projected scales (source resolution <= ``coarse_proj``): their
   tiny volumes are projected through the fc_0 tap blocks first, and the
   seven projected taps of every scale at the queries, summed, give their
   fc_0 term (``voxel.py`` ``CoarseTerm``), per slab or once, hoisted.
   On the card each is one launch of the ``voxel_taps`` kernel; on the CPU
   the plain version (z/y tap variants, banded x-lerp products).
3. Perceptual maps are resized once and projected through the fc_0 percep
   rows before the 4-corner bilinear gather (``percep_maps`` and
   ``percep_sample``, the block DISN's decode shares).
4. The head, by ``use_pallas`` as in the JAX package: 2 (the default
   here) ``fused_stack_head`` (K1 on the card, its plain version on the
   CPU); 0 the JAX package's XLA head, which is ``fused_stack_head_plain``
   on any device; 1 the per-scale path: no grouping and no hoisted
   variants, each kept scale's seven taps one batched product giving a
   t-major (7, n, C) stack, the coarse term folded into the perceptual one
   and the sum cast to the compute dtype, and ``fused_fc0_mlp`` (K4 on the
   card) as the head.

``disn_grid_sdf`` is DISN's dense decode (``models/disn.py``): the
same perceptual block on its local stream's pixel rows, then its two
streams' MLPs per slab.

The JAX ``lax.scan`` over slabs is a Python generator here
(``dense_grid_slabs``; ``dense_grid_sdf`` concatenates it).  The host
plans and indices stay on each device (``ops/consts.py``), so a warm
decode never waits for the device.  ``compute_dtype``
is bf16 in production and f32 in the parity tests; where the JAX package
keeps an f32 product of bf16 operands, operands are upcast before the
product (exact), and where it casts straight back, the cast follows.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from list_tpu_torch.ops.consts import device_const
from list_tpu_torch.ops.cuda import percep as percep_cuda
from list_tpu_torch.ops.cuda import voxel
from list_tpu_torch.ops.cuda.percep import PERCEP_MAP
from list_tpu_torch.ops.cuda.fused_fc0 import (fused_fc0_mlp,
                                               fused_stack_head,
                                               fused_stack_head_plain)
from list_tpu_torch.ops.sampling import resize_bilinear_align_corners
from list_tpu_torch.utils.spans import span

_mm32 = voxel.mm32


# ---- fc_0 rows of the voxel taps ----------------------------------------------

def _scale_w1_rows(channels: Sequence[int], scale_idx: int) -> np.ndarray:
    """fc_0 rows of one scale in the (disp, channel) stack order."""
    offset = sum(channels[:scale_idx])
    return np.asarray([(offset + ch) * 7 + d for d in range(7)
                       for ch in range(channels[scale_idx])], np.int64)


def _group_w1_rows(channels: Sequence[int], group: Sequence[int]
                   ) -> np.ndarray:
    """fc_0 rows of a same-resolution group in the structured stack order
    [taps 0-4 | tap 5 (x-) | tap 6 (x+)]."""
    rows = []
    for d in range(7):
        for si in group:
            offset = sum(channels[:si])
            rows += [(offset + ch) * 7 + d for ch in range(channels[si])]
    return np.asarray(rows, np.int64)


# ---- the perceptual block (LIST's and DISN's dense decodes) -----------------

def percep_maps(feat_l2: Sequence[torch.Tensor], w_rows: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """One image's channels-last (1, H, W, C) maps resized to the 137^2
    map (align corners), concatenated and projected through ``w_rows``
    (sum C, out), the first layer's pixel rows, on ``dt`` operands with
    an f32 product -> (137^2, out) in ``dt``.  The projection before the
    bilinear sample is exact: both are linear."""
    ms = PERCEP_MAP
    pmaps = torch.cat([resize_bilinear_align_corners(f, ms, ms)
                       for f in feat_l2], dim=-1)  # (1, 137, 137, sum C)
    pm = _mm32(pmaps.to(dt), w_rows.to(dt)).to(dt)
    return pm[0].reshape(ms * ms, -1)


def percep_sample(flat_pm: torch.Tensor, t: torch.Tensor, p0: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor, dt: torch.dtype
                  ) -> torch.Tensor:
    """The projected map ``flat_pm`` (``percep_maps``) at the queries
    (p0, p1, p2), each (S, R, R): (p0, p1, p2, 1) through the (4, 3) camera
    ``t`` with the perspective divide (+1e-8), clamped to the map, the
    4-corner gather and the bilinear in ``dt`` -> (n, out).  On the card
    one kernel launch (``ops/cuda/percep.py``: a bf16 or f32 map, the
    bilinear in f32, rounded to bf16 once), on the CPU the plain version."""
    return percep_cuda.percep_sample(flat_pm, t, p0, p1, p2, dt)


def dense_grid_sdf(*args, **kwargs) -> torch.Tensor:
    """Dense (R^3) SDF for batch size 1 -> (R, R, R) f32 raw SDF, or with
    ``x_range`` (x0, x1) its x rows [x0, x1) as (x1 - x0, R, R): the slabs
    of ``dense_grid_slabs`` (same arguments), concatenated."""
    return torch.cat(list(dense_grid_slabs(*args, **kwargs)), dim=0)


@torch.no_grad()
def dense_grid_slabs(decoder, vox_feats: List[torch.Tensor],
                     feat_l2: List[torch.Tensor], trans_mat: torch.Tensor,
                     vox_res: int, slab: Optional[int] = None,
                     delta: float = 0.0722,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     bb_min: float = -0.5, bb_max: float = 0.5,
                     coarse_proj: int = 16,
                     coarse_outside: Optional[bool] = None,
                     hoist_variants: Optional[bool] = None,
                     use_pallas: int = 2,
                     x_range: Optional[Tuple[int, int]] = None
                     ) -> Iterator[torch.Tensor]:
    """The dense (R^3) SDF of one image (batch size 1) as a generator of
    its x slabs, each (slab, R, R) f32 raw SDF, over all x rows or with
    ``x_range`` (x0, x1) over rows [x0, x1), a whole number of slabs (one
    device's block of the JAX package's ``shard_map`` over the slabs).
    The first slab also runs the setup (perceptual projection, groups,
    coarse term), so that a caller can queue several devices' slabs in
    turns (``LISTExecutor._decode``).

    decoder: the ``VoxelDecoder2`` (fc_0..fc_out Linear layers).
    vox_feats: channels-last (1, R_s, R_s, R_s, C_s) volumes; feat_l2:
    (1, H, W, C) pyramid maps; trans_mat (1, 4, 3).  ``slab`` defaults to R
    (the whole grid in one step).  ``hoist_variants`` (auto: R <= 128 and
    slab <= 16) builds each group's z/y tap variants once for the whole
    volume in the plain version (on the card it changes nothing: the
    kernel builds no variants); ``coarse_outside`` (auto: R <= 128)
    computes the coarse term for the x rows once, in the compute dtype,
    else per slab in f32.  ``use_pallas`` picks
    the head (module docstring): 0 and 2 take the structured parts, 1 the
    per-scale stacks.

    Spans (``utils/spans.py``, with events on the features' device):
    ``decode.percep``, the perceptual maps' resize and fc_0 projection,
    then in each slab the pixel projection, the 4-corner gather and the
    bilinear; ``decode.voxel``, the groups' setup (the plain version's
    hoisted z/y variants), the coarse taps' projection and, hoisted, the
    coarse term, then in each slab the groups' taps and the slab's coarse
    term (on the card one ``voxel_taps`` launch a group and one for the
    coarse term).  The head is neither.
    """
    R = vox_res
    S = R if slab is None else int(slab)
    assert R % S == 0, (R, S)
    x0, x1 = (0, R) if x_range is None else (int(v) for v in x_range)
    if not (0 <= x0 < x1 <= R and x0 % S == 0 and x1 % S == 0):
        raise ValueError(f'x_range {x_range}: whole slabs of {S} in [0, {R}]')
    k0, k1 = x0 // S, x1 // S
    dt = compute_dtype
    use_pallas = int(use_pallas)
    if use_pallas not in (0, 1, 2):
        raise ValueError(f'use_pallas must be 0, 1 or 2, got {use_pallas}')
    structured = use_pallas != 1
    dev = vox_feats[0].device
    channels = tuple(int(f.shape[-1]) for f in vox_feats)
    w1 = decoder.fc_0.weight.t()  # (3610, 512), JAX (in, out) layout
    b1 = decoder.fc_0.bias
    n_vox_rows = sum(channels) * 7
    n_percep = sum(int(f.shape[-1]) for f in feat_l2)
    w1v = w1[:n_vox_rows]

    proj = tuple(si for si, f in enumerate(vox_feats)
                 if f.shape[1] <= coarse_proj)
    if len(proj) == len(vox_feats):
        proj = ()  # degenerate tiny models: keep the plain path
    kept = tuple(si for si in range(len(vox_feats)) if si not in proj)

    def rows(key, make) -> torch.Tensor:
        """fc_0 row indices, kept on the device; the gather stays per
        call, so it reads the current weights."""
        return device_const(('w1_rows', channels) + key, make, dev)

    if structured:
        groups = []
        for si in kept:
            if groups and vox_feats[groups[-1][0]].shape[1] \
                    == vox_feats[si].shape[1]:
                groups[-1] = groups[-1] + (si,)
            else:
                groups.append((si,))
        # fc_0 rows of each structured part [A5 | Ax- | Ax+] per group
        w1_parts = []
        for g in groups:
            cg = sum(channels[si] for si in g)
            for j, sl in enumerate((slice(0, 5 * cg), slice(5 * cg, 6 * cg),
                                    slice(6 * cg, 7 * cg))):
                w1_parts.append(w1v[rows(
                    ('group', g, j),
                    lambda g=g, sl=sl: _group_w1_rows(channels, g)[sl])
                ].to(dt))
    else:
        # per kept scale: its (disp, channel) stack's fc_0 rows
        groups = [(si,) for si in kept]
        w1_parts = [w1v[rows(('scale', si),
                             lambda si=si: _scale_w1_rows(channels, si))
                        ].to(dt) for si in kept]
    w1_percep = w1[n_vox_rows:n_vox_rows + n_percep]
    w1_xyz = w1[n_vox_rows + n_percep:]

    # perceptual maps: resize once, project through the fc_0 percep rows
    with span('decode.percep', dev):
        flat_pm = percep_maps(feat_l2, w1_percep, dt)

    with span('decode.voxel', dev):
        vols = [f[0].to(dt) for f in vox_feats]
        n = S * R * R
        if hoist_variants is None:
            hoist_variants = R <= 128 and S <= 16
        kept_taps = [voxel.KeptTaps(
            vols[g[0]] if len(g) == 1
            else torch.cat([vols[si] for si in g], dim=-1),
            R, S, delta, bb_min, bb_max, hoist=hoist_variants,
            structured=structured) for g in groups]

        # coarse-projected volumes through the fc_0 tap blocks, P(t): one
        # product a scale against its rows (channel, tap), columns
        # [P(0) | ... | P(6)]
        coarse_term = None
        if proj:
            taps = []
            for si in proj:
                off, C = 7 * sum(channels[:si]), channels[si]
                P7 = _mm32(vols[si], w1v[off:off + 7 * C].reshape(
                    C, -1).to(dt)).to(dt)
                D = P7.shape[-1] // 7
                taps.append([P7[..., t * D:(t + 1) * D] for t in range(7)])
            if coarse_outside is None:
                coarse_outside = R <= 128
            coarse_term = voxel.CoarseTerm(taps, R, S, delta, bb_min, bb_max,
                                           (x0, x1), coarse_outside)
            del taps

    w2 = decoder.fc_1.weight.t()
    w3 = decoder.fc_2.weight.t()
    w4 = decoder.fc_out.weight.t()
    b2, b3, b4 = decoder.fc_1.bias, decoder.fc_2.bias, decoder.fc_out.bias
    t = trans_mat[0].float()
    step = (bb_max - bb_min) / (R - 1)
    ar = torch.arange(R, dtype=torch.float32, device=dev)
    ar_s = torch.arange(S, dtype=torch.float32, device=dev)

    for k in range(k0, k1):
        xs = k * S
        with span('decode.voxel', dev):
            parts = [p for kt in kept_taps for p in kt.slab(k)]
            coarse = None if coarse_term is None else coarse_term.slab(k)

        # perceptual part from the projected 512-channel map
        with span('decode.percep', dev):
            fx = ((ar_s + xs) * step + bb_min)[:, None, None].expand(S, R, R)
            fy = (ar * step + bb_min)[None, :, None].expand(S, R, R)
            fz = (ar * step + bb_min)[None, None, :].expand(S, R, R)
            p0, p1, p2 = 2.0 * fz, 2.0 * fy, 2.0 * fx
            percep = percep_sample(flat_pm, t, p0, p1, p2, dt)

        qxyz = torch.stack([p0, p1, p2], dim=-1).reshape(n, 3)
        tail = (w1_xyz, b1, w2, b2, w3, b3, w4, b4)
        if use_pallas == 1:
            p512 = percep.float()
            if coarse is not None:
                p512 = p512 + coarse.float()
            del percep, coarse
            sdf = fused_fc0_mlp(parts, p512.to(dt), qxyz, w1_parts, *tail)
        else:
            head = fused_stack_head if use_pallas == 2 \
                else fused_stack_head_plain
            sdf = head(parts, coarse, percep, qxyz, w1_parts, *tail)
        del parts
        yield sdf.reshape(S, R, R)


# ---- DISN ----------------------------------------------------------------------

def _stream_weights(stream, dt: torch.dtype):
    """A DISN stream's layers as (W^T, bias) pairs: the point MLP (its
    first layer in f32: its K = 3 product takes the f32 coordinates; the
    rest in ``dt``), the head's first layer without its image rows, the
    head's other layers, and the output layer's W^T in f32."""
    pts = [getattr(stream, f'point{i + 1}') for i in range(stream.n_point)]
    fcs = [getattr(stream, f'fc{i + 1}') for i in range(stream.n_head)]
    point = [(pts[0].weight.t().float(), pts[0].bias.float())]
    point += [(m.weight.t().to(dt), m.bias.to(dt)) for m in pts[1:]]
    n_pt = pts[-1].out_features
    first = (fcs[0].weight[:, :n_pt].t().to(dt), fcs[0].bias.to(dt))
    rest = [(m.weight.t().to(dt), m.bias.to(dt)) for m in fcs[1:]]
    return point, first, rest, stream.fc_out.weight.t().float()


def _stream_hidden(xyz: torch.Tensor, point, first, rest,
                   feat: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One stream up to its output layer over n queries: the point MLP
    (ReLU after every layer), the head's first layer with ``feat`` (n, H)
    or (H,) added, then its bias (None: in ``feat``) and ReLU, and the
    head's other layers."""
    (w, b), *more = point
    h = torch.addmm(b, xyz, w).relu_().to(dt)
    for w, b in more:
        h = torch.addmm(b, h, w).relu_()
    w, b = first
    h = torch.addmm(feat, h, w)
    if b is not None:
        h.add_(b)
    h.relu_()
    for w, b in rest:
        h = torch.addmm(b, h, w).relu_()
    return h


@torch.no_grad()
def disn_grid_sdf(model, enc, vox_res: int, slab: Optional[int] = None,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  bb_min: float = -0.5, bb_max: float = 0.5) -> torch.Tensor:
    """DISN's (R, R, R) f32 raw SDF of one image (batch size 1) from its
    encoding (``models/disn.py`` ``encode``), decoded in x slabs of
    ``slab`` rows (default R).

    The global stream's image rows enter as one bias of the image (its
    1,024 features through them, plus the layer's bias, in f32); the local
    stream's pixel rows project the five maps once (``percep_maps``), and
    each slab samples the projected map at its queries' pixels
    (``percep_sample``).  Then
    per slab both streams' point MLPs and heads on ``compute_dtype``
    operands with f32 accumulation (the first point layer, K = 3, on the
    f32 coordinates), and the two output layers in f32 on the last hidden
    layers, summed.

    Spans (``utils/spans.py``, with events on the encoding's device):
    ``decode.percep``, the maps' projection, then in each slab the pixel
    projection, the 4-corner gather and the bilinear; ``decode.head``, the
    global bias, then in each slab the point MLPs, both streams' products
    and the sum."""
    R = vox_res
    S = R if slab is None else int(slab)
    assert R % S == 0, (R, S)
    dt = compute_dtype
    glob = enc['global']
    dev = glob.device
    sg, sl = model.stream_g, model.stream_l
    n_pt = sg.fc1.in_features - glob.shape[-1]  # the point feature
    with span('decode.percep', dev):
        flat_pm = percep_maps(enc['feat_l2'], sl.fc1.weight[:, n_pt:].t(), dt)
    with span('decode.head', dev):
        pg, (wg, _), rg, og = _stream_weights(sg, dt)
        pl, fl, rl, ol = _stream_weights(sl, dt)
        bias_g = torch.addmm(sg.fc1.bias.float(), glob[:1].float(),
                             sg.fc1.weight[:, n_pt:].t().float())[0].to(dt)
        b_out = (sg.fc_out.bias + sl.fc_out.bias).float()
    t = enc['trans_mat'][0].float()
    step = (bb_max - bb_min) / (R - 1)
    ar = torch.arange(R, dtype=torch.float32, device=dev)
    ar_s = torch.arange(S, dtype=torch.float32, device=dev)
    out = []
    for k in range(R // S):
        with span('decode.percep', dev):
            fx = ((ar_s + k * S) * step + bb_min)[:, None, None].expand(
                S, R, R)
            fy = (ar * step + bb_min)[None, :, None].expand(S, R, R)
            fz = (ar * step + bb_min)[None, None, :].expand(S, R, R)
            local = percep_sample(flat_pm, t, fx, fy, fz, dt)
        with span('decode.head', dev):
            xyz = torch.stack([fx, fy, fz], -1).reshape(-1, 3)
            h_g = _stream_hidden(xyz, pg, (wg, None), rg, bias_g, dt)
            h_l = _stream_hidden(xyz, pl, fl, rl, local, dt)
            del local
            sdf = torch.addmm(b_out, h_g.float(), og)
            del h_g
            sdf = torch.addmm(sdf, h_l.float(), ol)
            del h_l
        out.append(sdf.reshape(S, R, R))
    return torch.cat(out)
