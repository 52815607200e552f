"""Dense-grid SDF decode for one image
(counterpart of ``list_tpu/ops/dense_grid.py::dense_grid_sdf``).

The inference queries are the regular grid ``linspace(bb_min, bb_max, R)``,
so trilinear sampling factorizes per axis with static indices and weights
(the numpy plans below are copies of the JAX package's).  Per x-slab:

1. Voxel features: same-resolution kept scales are grouped, resampled in z
   and y to R (five tap variants), and the x-lerp of all seven displacement
   taps is one banded-matrix product per group, giving the structured
   parts ``[A5 | Ax- | Ax+]``.
2. Coarse-projected scales (source resolution <= ``coarse_proj``): their
   tiny volumes are projected through the fc_0 tap blocks first, the seven
   taps fold into three volumes, and one banded product per slab (or once,
   hoisted) gives their summed fc_0 term.
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

import functools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from list_tpu_torch.ops.consts import device_const
from list_tpu_torch.ops.cuda import percep as percep_cuda
from list_tpu_torch.ops.cuda.percep import PERCEP_MAP
from list_tpu_torch.ops.cuda.fused_fc0 import (fused_fc0_mlp,
                                               fused_stack_head,
                                               fused_stack_head_plain)
from list_tpu_torch.ops.sampling import resize_bilinear_align_corners
from list_tpu_torch.utils.spans import span

# taps in the reference displacement order d=0..6: (x_shift_sign, (sy, sz))
TAPS = ((0, (0, 0)), (0, (0, -1)), (0, (0, 1)), (0, (-1, 0)),
        (0, (1, 0)), (-1, (0, 0)), (1, (0, 0)))
# x-tap variants of the coarse-projected path: (center, +x, -x)
XTAPS = ((0, None), (1, None), (-1, None))


# ---- static numpy plans (copies of the JAX package's) -----------------------

def _axis_positions(r_out: int, r_in: int, shift: float,
                    bb_min: float = -0.5, bb_max: float = 0.5) -> np.ndarray:
    w = bb_min + np.arange(r_out) * (bb_max - bb_min) / max(r_out - 1, 1)
    pos = (2.0 * w + 1.0) * 0.5 * (r_in - 1) + shift
    return np.clip(pos, 0.0, r_in - 1)


def _axis_plan(r_out: int, r_in: int, shift: float,
               bb_min: float = -0.5, bb_max: float = 0.5):
    """Static (i0, i1, w) for 1-D border-clamped linear resampling."""
    pos = _axis_positions(r_out, r_in, shift, bb_min, bb_max)
    i0 = np.floor(pos).astype(np.int32)
    w = (pos - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, r_in - 1).astype(np.int32)
    return i0, i1, w


def norm_shift(s: float, r_in: int) -> float:
    """Normalized-space displacement -> input-voxel units."""
    return s * (r_in - 1) / 2.0


def _scale_w1_rows(channels: Sequence[int], scale_idx: int) -> np.ndarray:
    """fc_0 rows of one scale in the (disp, channel) stack order."""
    offset = sum(channels[:scale_idx])
    return np.asarray([(offset + ch) * 7 + d for d in range(7)
                       for ch in range(channels[scale_idx])], np.int64)


def _tap_w1_rows(channels: Sequence[int], scale_idx: int,
                 tap: int) -> np.ndarray:
    offset = sum(channels[:scale_idx])
    return np.asarray([(offset + ch) * 7 + tap
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


def _slab_x_plans(R, r_in, x0, S, delta, bb_min, bb_max, taps=TAPS):
    plans = {sgn: _axis_plan(R, r_in, norm_shift(delta * sgn, r_in),
                             bb_min, bb_max) for sgn in (-1, 0, 1)}
    lo = min(int(p[0][x0]) for p in plans.values())
    hi = max(int(p[1][x0 + S - 1]) for p in plans.values()) + 1
    L = np.zeros((len(taps), S, hi - lo), np.float32)
    for t, (sgn, _) in enumerate(taps):
        i0, i1, w = plans[sgn]
        for s in range(S):
            L[t, s, i0[x0 + s] - lo] += 1.0 - w[x0 + s]
            L[t, s, i1[x0 + s] - lo] += w[x0 + s]
    return lo, hi, L


def _scan_x_plans_full(R, r_in, S, delta, bb_min, bb_max, taps=XTAPS):
    """(nslabs, len(taps), S, r_in) full-window banded x-lerp matrices."""
    assert R % S == 0, (R, S)
    plans = {sgn: _axis_plan(R, r_in, norm_shift(delta * sgn, r_in),
                             bb_min, bb_max) for sgn in (-1, 0, 1)}
    L = np.zeros((R // S, len(taps), S, r_in), np.float32)
    for t, (sgn, _) in enumerate(taps):
        i0, i1, w = plans[sgn]
        for x in range(R):
            L[x // S, t, x % S, i0[x]] += 1.0 - w[x]
            L[x // S, t, x % S, i1[x]] += w[x]
    return L


def _scan_x_plans(R, r_in, S, delta, bb_min, bb_max, taps=TAPS):
    """Shape-uniform per-slab plans: (los (nslabs,), Ls (nslabs, len(taps),
    S, r_max)); window starts clamped so lo + r_max <= r_in."""
    assert R % S == 0, (R, S)
    raw = [_slab_x_plans(R, r_in, k * S, S, delta, bb_min, bb_max, taps)
           for k in range(R // S)]
    r_max = max(hi - lo for lo, hi, _ in raw)
    los = np.zeros(R // S, np.int32)
    Ls = np.zeros((R // S, len(taps), S, r_max), np.float32)
    for k, (lo, hi, L7) in enumerate(raw):
        lo2 = min(lo, r_in - r_max)
        off = lo - lo2
        los[k] = lo2
        Ls[k, :, :, off:off + (hi - lo)] = L7
    return los, Ls


# the per-slab plans of an (R, r_in, S, delta, bb) once per process: the
# decode reads their window starts on the host at every call
_host_x_plans = functools.lru_cache(maxsize=64)(_scan_x_plans)


# ---- tensor helpers ----------------------------------------------------------

def resample_axis(vol: torch.Tensor, axis: int, r_out: int, shift: float,
                  bb_min: float = -0.5, bb_max: float = 0.5) -> torch.Tensor:
    """Border-clamped linear resample of one axis (static indices, kept on
    the device)."""
    key = (r_out, int(vol.shape[axis]), shift, bb_min, bb_max)
    plan = lambda: _axis_plan(*key)  # noqa: E731
    idx = device_const(('resample_idx',) + key,
                       lambda: np.stack(plan()[:2]), vol.device, torch.long)
    wshape = [1] * vol.ndim
    wshape[axis] = r_out
    w = device_const(('resample_w',) + key, lambda: plan()[2], vol.device,
                     vol.dtype).reshape(wshape)
    v0 = vol.index_select(axis, idx[0])
    v1 = vol.index_select(axis, idx[1])
    return v0 * (1.0 - w) + v1 * w


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of (possibly bf16) operands with f32 accumulation."""
    return a.float() @ b.float()


def _xlerp(L: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """einsum('sr,ryz...->syz...') with an f32 result."""
    return _mm32(L, V.reshape(V.shape[0], -1)).reshape(
        (L.shape[0],) + tuple(V.shape[1:]))


def _dyn_slice0(v: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """lax.dynamic_slice on axis 0: the start is clamped into range."""
    start = max(0, min(int(start), v.shape[0] - size))
    return v[start:start + size]


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
    volume; ``coarse_outside`` (auto: R <= 128) computes the coarse term for
    the whole grid once, cast to the compute dtype.  ``use_pallas`` picks
    the head (module docstring): 0 and 2 take the structured parts, 1 the
    per-scale stacks.

    Spans (``utils/spans.py``, with events on the features' device):
    ``decode.percep``, the perceptual maps' resize and fc_0 projection,
    then in each slab the pixel projection, the 4-corner gather and the
    bilinear; ``decode.voxel``, the groups' z/y variants, the coarse term,
    then in each slab the x-lerps that build the parts.  The head is
    neither.
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
        nslabs = R // S
        ent_vols = [vols[g[0]] if len(g) == 1
                    else torch.cat([vols[si] for si in g], dim=-1)
                    for g in groups]
        ent_chs = [sum(channels[si] for si in g) for g in groups]
        plan_los, plan_Ls = [], []
        for g in groups:
            key = (R, int(vols[g[0]].shape[0]), S, delta, bb_min, bb_max)
            # the window starts stay host integers (_dyn_slice0's)
            plan_los.append(_host_x_plans(*key)[0])
            plan_Ls.append(device_const(('x_plans',) + key,
                                        lambda key=key: _host_x_plans(*key)[1],
                                        dev, dt))

        if hoist_variants is None:
            hoist_variants = R <= 128 and S <= 16
        hoist = bool(hoist_variants) and structured
        ent_ident = []
        for f in ent_vols:
            i0, _, w = _axis_plan(R, f.shape[0], 0.0, bb_min, bb_max)
            ent_ident.append(bool((w == 0).all()
                                  and (i0 == np.arange(R)).all()))

        def zy_variants(f, r_in):
            dz = norm_shift(delta, r_in)
            z0 = resample_axis(f, 2, R, 0.0, bb_min, bb_max)
            zp = resample_axis(f, 2, R, dz, bb_min, bb_max)
            zm = resample_axis(f, 2, R, -dz, bb_min, bb_max)
            return {
                (0, 0): resample_axis(z0, 1, R, 0.0, bb_min, bb_max),
                (1, 0): resample_axis(z0, 1, R, dz, bb_min, bb_max),
                (-1, 0): resample_axis(z0, 1, R, -dz, bb_min, bb_max),
                (0, 1): resample_axis(zp, 1, R, 0.0, bb_min, bb_max),
                (0, -1): resample_axis(zm, 1, R, 0.0, bb_min, bb_max),
            }

        if hoist:
            ent_vols = [torch.cat([v[key] for (_, key) in TAPS[:5]], dim=-1)
                        for v in (zy_variants(f, f.shape[0])
                                  for f in ent_vols)]

        # coarse-projected volumes, folded through the fc_0 tap blocks
        proj_vols = []
        for si in proj:
            V = vols[si]
            r_in = V.shape[0]
            dz = norm_shift(delta, r_in)

            def P(t, si=si, V=V):
                return _mm32(V, w1v[rows(
                    ('tap', si, t),
                    lambda: _tap_w1_rows(channels, si, t))].to(dt)).to(dt)

            def rz(v, s):
                return resample_axis(v, 2, R, s, bb_min, bb_max)

            def ry(v, s):
                return resample_axis(v, 1, R, s, bb_min, bb_max)

            # TAPS order: t0 center, t1 z-, t2 z+, t3 y-, t4 y+, t5 x-, t6 x+
            Tc = rz(P(0), 0.0) + rz(P(2), dz) + rz(P(1), -dz)
            U0 = ry(Tc, 0.0) + ry(rz(P(4), 0.0), dz) + ry(rz(P(3), 0.0), -dz)
            Uxp = ry(rz(P(6), 0.0), 0.0)
            Uxm = ry(rz(P(5), 0.0), 0.0)
            proj_vols.extend(U.reshape(r_in, R * R, U.shape[-1])
                             for U in (U0, Uxp, Uxm))

        if coarse_outside is None:
            coarse_outside = R <= 128
        outside = bool(proj) and coarse_outside
        Ucat = Lcat = Cfull = None
        if proj:
            Ucat = torch.cat(proj_vols, dim=0)  # (Ktot, R*R, 512)
            r_ins = tuple(int(vols[si].shape[0]) for si in proj)

            def coarse_plans():
                return np.concatenate(
                    [np.transpose(_scan_x_plans_full(R, r_in, S, delta, bb_min,
                                                     bb_max),
                                  (0, 2, 1, 3)).reshape(nslabs, S, -1)
                     for r_in in r_ins], axis=-1)

            Lcat = device_const(('coarse_x_plans', R, S, delta, bb_min, bb_max,
                                 r_ins), coarse_plans, dev, dt)
            if outside:
                # the x rows' coarse term once, cast to the compute dtype
                Cfull = _mm32(Lcat[k0:k1].reshape(x1 - x0, -1),
                              Ucat.reshape(Ucat.shape[0], -1)).to(dt)
                Cfull = Cfull.reshape(x1 - x0, R * R, -1)
                Ucat = None

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
            parts = []
            for gi, f in enumerate(ent_vols):
                ch = ent_chs[gi]
                L7 = plan_Ls[gi][k]
                r_max = L7.shape[-1]
                if hoist:
                    sub = _dyn_slice0(f, plan_los[gi][k], r_max)
                    if ent_ident[gi]:
                        A5 = _dyn_slice0(f, xs, S).reshape(n, 5 * ch)
                    else:
                        A5 = _xlerp(L7[0], sub).to(dt).reshape(n, 5 * ch)
                    Vx = sub[..., :ch]
                else:
                    r_in = f.shape[0]
                    sub = _dyn_slice0(f, plan_los[gi][k], r_max)
                    variants = zy_variants(sub, r_in)
                    if not structured:
                        # (7, r, R, R, C): each tap's source rows; one batched
                        # x-lerp 'tsr,tryzc->tsyzc' (f32), cast, f32 freed
                        V7 = torch.stack([variants[key] for (_, key) in TAPS])
                        del variants
                        A = torch.bmm(L7.float(),
                                      V7.reshape(7, r_max, -1).float())
                        del V7
                        parts.append(A.to(dt).reshape(7, n, ch))
                        del A
                        continue
                    Vcat = torch.cat([variants[key] for (_, key) in TAPS[:5]],
                                     dim=-1)
                    A5 = _xlerp(L7[0], Vcat).to(dt).reshape(n, 5 * ch)
                    Vx = variants[(0, 0)]
                Axm = _xlerp(L7[5], Vx).to(dt).reshape(n, ch)
                Axp = _xlerp(L7[6], Vx).to(dt).reshape(n, ch)
                parts += [A5.contiguous(), Axm, Axp]

            coarse = None
            if outside:
                coarse = Cfull[xs - x0:xs - x0 + S].reshape(n, -1)
            elif Ucat is not None:
                coarse = _mm32(Lcat[k], Ucat.reshape(Ucat.shape[0], -1)
                               ).reshape(n, -1)

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
