"""The dense decode's voxel work: the kept scales' seven displacement taps
and the coarse-projected scales' summed fc_0 term at the regular query
grid, slab by slab.

Replaces no TPU kernel: the JAX package leaves this work to XLA
(``list_tpu/ops/dense_grid.py:563-605``).  On a CUDA tensor one launch of
``voxel_taps`` (``csrc/voxel_taps.cu``; its header states the bound on an
H100 and what the design does about it) takes the place of the plain
version's PyTorch passes: index_select gathers and bf16 lerps along z and y
into five tap variants, their concatenation, an f32 banded x-lerp product
and a cast back; for the coarse term the z/y fold of the projected taps
into (r, R, R, 512) volumes, their concatenation, an f32 product and a cast.

- ``KeptTaps(vol, R, S, delta, bb_min, bb_max, hoist, structured)``: a
  same-resolution group's channels-last (r, r, r, C) volume in the compute
  dtype; ``slab(k)`` gives slab k's structured parts ``[A5 (n, 5C) | Ax-
  (n, C) | Ax+ (n, C)]`` (n = S R^2), or with ``structured`` False the
  t-major stack (7, n, C) in a list, in the volume's dtype.
- ``CoarseTerm(taps, R, S, delta, bb_min, bb_max, x_range, outside)``: per
  projected scale its seven tap volumes P(t) (r, r, r, D), each the scale
  through its fc_0 tap block (``TAPS`` order); ``slab(k)`` gives the
  (n, D) sum of every scale's seven taps at slab k's queries: with
  ``outside`` computed once over ``x_range`` in the compute dtype, else per
  slab in f32.

A CPU tensor (or ``plain``, on any device) takes the plain version, the
dense decode's arithmetic as it was, bit for bit: ``hoist`` builds a group's z/y variants once for all
slabs, and the x-lerps take the plans in the compute dtype.  A CUDA tensor
launches the kernel (``hoist`` changes nothing there: it builds no
variants) or raises: bf16 volumes only (an f32 or f64 decode runs on the
CPU).  The kernel computes every lerp in f32 from the bf16 volumes with the
plans' f32 weights and rounds each output element once; the coarse term's
fold stays in its registers.  Its segments of one row take 4-channel
(8-byte) vectors where C, strides, offsets and pointers allow (the 32- and
64-channel groups, the coarse term), else single channels (the 17-channel
group); ``vec_path`` records the last launch's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from list_tpu_torch.device import H100_SXM
from list_tpu_torch.ops.consts import device_const
from list_tpu_torch.ops.cuda import build

SOURCE = 'list_tpu_torch/csrc/voxel_taps.cu'
# taps in the reference displacement order d=0..6: (x_shift_sign, (sy, sz))
TAPS = ((0, (0, 0)), (0, (0, -1)), (0, (0, 1)), (0, (-1, 0)),
        (0, (1, 0)), (-1, (0, 0)), (1, (0, 0)))
# x-tap variants of the coarse-projected path: (center, +x, -x)
XTAPS = ((0, None), (1, None), (-1, None))
# the launch table's sizes (csrc/voxel_taps.cu kMax*)
MAX_MEMBERS, MAX_GROUPS, MAX_SEGS = 48, 24, 8
# kernel launches since the last reset (launches only, never plain calls)
launches = 0
# channels a thread took at the last launch: 4 (8-byte vectors) or 1
vec_path = 0


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


def _kernel_plans(R: int, r_ins: Tuple[int, ...], delta: float,
                  bb_min: float, bb_max: float) -> np.ndarray:
    """The kernel's plan table (3 len(r_ins), R, 2) int32: row
    3 i + (s + 1) is the shift s in (-1, 0, 1) of source resolution
    r_ins[i], each entry (i0 | i1 << 16, the f32 bits of w)."""
    if max(r_ins) > 0x7fff or R > 0xffff:
        raise ValueError(f'voxel_taps: resolutions {r_ins} -> {R} past its '
                         'plan table')
    rows = []
    for r in r_ins:
        for s in (-1, 0, 1):
            i0, i1, w = _axis_plan(R, r, norm_shift(delta * s, r), bb_min,
                                   bb_max)
            rows.append(np.stack([i0 | i1 << 16, w.view(np.int32)], -1))
    return np.stack(rows)


# ---- the plain version's tensor helpers ---------------------------------------

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


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of (possibly bf16) operands with f32 accumulation."""
    return a.float() @ b.float()


def _xlerp(L: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """einsum('sr,ryz...->syz...') with an f32 result."""
    return mm32(L, V.reshape(V.shape[0], -1)).reshape(
        (L.shape[0],) + tuple(V.shape[1:]))


def _dyn_slice0(v: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """lax.dynamic_slice on axis 0: the start is clamped into range."""
    start = max(0, min(int(start), v.shape[0] - size))
    return v[start:start + size]


def zy_variants(f: torch.Tensor, r_in: int, R: int, delta: float,
                bb_min: float, bb_max: float) -> dict:
    """The five z/y tap variants {(sy, sz): (rows, R, R, C)} of ``f``'s x
    rows, a volume of source resolution ``r_in``."""
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


# ---- the kernel's launch ------------------------------------------------------

class _Member(ctypes.Structure):
    _fields_ = [('inp', ctypes.c_void_p), ('sx', ctypes.c_int),
                ('sy', ctypes.c_int), ('sz', ctypes.c_int),
                ('yplan', ctypes.c_int), ('zplan', ctypes.c_int)]


class _Group(ctypes.Structure):
    _fields_ = [('xplan', ctypes.c_int), ('m0', ctypes.c_int),
                ('m1', ctypes.c_int), ('seg', ctypes.c_int)]


class _Seg(ctypes.Structure):
    _fields_ = [('out', ctypes.c_void_p), ('stride', ctypes.c_longlong),
                ('off', ctypes.c_longlong)]


class _Launch(ctypes.Structure):
    _fields_ = [('m', _Member * MAX_MEMBERS), ('g', _Group * MAX_GROUPS),
                ('s', _Seg * MAX_SEGS), ('plans', ctypes.c_void_p),
                ('R', ctypes.c_int), ('n_plans', ctypes.c_int),
                ('ng', ctypes.c_int), ('nm', ctypes.c_int),
                ('C', ctypes.c_int),
                ('x0', ctypes.c_int), ('nx', ctypes.c_int),
                ('ny', ctypes.c_int), ('nz', ctypes.c_int)]


def check_volume(vol: torch.Tensor, what: str) -> torch.Tensor:
    """``vol`` as the kernel reads it: a bf16 (r, r, r, C) CUDA tensor
    whose elements lie within 2^31 of its first, with contiguous channels
    (copied if they are not: a view of a projected tap's columns is read
    in place); raises on any other."""
    if vol.stride(-1) != 1:
        vol = vol.contiguous()
    span = sum((n - 1) * st for n, st in zip(vol.shape, vol.stride())) + 1
    if vol.dtype != torch.bfloat16 or vol.dim() != 4 \
            or vol.device.type != 'cuda' or span >= 2 ** 31:
        raise TypeError(f'voxel_taps kernel takes bf16 (r, r, r, C) CUDA '
                        f'volumes spanning < 2^31 elements, got {what} '
                        f'{tuple(vol.shape)} {vol.dtype} on {vol.device}')
    return vol


def _launch(groups, segs, C: int, R: int, r_ins: Tuple[int, ...],
            delta: float, bb_min: float, bb_max: float, x0: int, nx: int,
            out_f32: bool) -> None:
    """One launch.  ``groups``: (x shift, [(volume, y shift, z shift)],
    segment index) in summation order, a segment's groups adjacent; each
    volume of source resolution in ``r_ins``; ``segs``: (output tensor, row
    stride, column offset) in elements.  The output rows are x in
    [x0, x0 + nx) of the R^3 grid, every y and z."""
    global launches, vec_path
    members = [m for _, ms, _ in groups for m in ms]
    if len(members) > MAX_MEMBERS or len(groups) > MAX_GROUPS \
            or len(segs) > MAX_SEGS:
        raise ValueError(f'voxel_taps: {len(members)} members, '
                         f'{len(groups)} groups, {len(segs)} segments; '
                         f'at most {MAX_MEMBERS}, {MAX_GROUPS}, {MAX_SEGS}')
    dev = segs[0][0].device
    plans = device_const(('voxel_plans', R, r_ins, delta, bb_min, bb_max),
                         lambda: _kernel_plans(R, r_ins, delta, bb_min,
                                               bb_max), dev, torch.int32)
    p = _Launch(plans=plans.data_ptr(), R=R, n_plans=plans.shape[0],
                ng=len(groups), nm=len(members), C=C, x0=x0, nx=nx, ny=R,
                nz=R)

    def row(r: int, s: int) -> int:
        return 3 * r_ins.index(r) + s + 1

    mi = 0
    for gi, (sx, ms, seg) in enumerate(groups):
        r = int(ms[0][0].shape[0])
        p.g[gi] = _Group(row(r, sx), mi, mi + len(ms), seg)
        for vol, sy, sz in ms:
            if vol.device != dev or tuple(vol.shape[:3]) != (r,) * 3 \
                    or vol.shape[3] < C:
                raise ValueError('voxel_taps: a group\'s volumes are '
                                 '(r, r, r, >= C) on the output\'s device')
            p.m[mi] = _Member(vol.data_ptr(), *vol.stride()[:3],
                              row(r, sy), row(r, sz))
            mi += 1
    for si, (out, stride, off) in enumerate(segs):
        want = torch.float32 if out_f32 else torch.bfloat16
        if out.device != dev or out.dtype != want or not out.is_contiguous():
            raise ValueError(f'voxel_taps: outputs are contiguous {want} on '
                             'one device')
        p.s[si] = _Seg(out.data_ptr(), stride, off)
    fn = build.load('voxel_taps').voxel_taps
    fn.argtypes = [ctypes.POINTER(_Launch), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vec = ctypes.c_int(0)
    build.launch(dev, 'voxel_taps', fn, ctypes.byref(p), int(out_f32),
                 ctypes.byref(vec))
    with build.count_lock:
        launches += 1
        vec_path = vec.value


# ---- the kept groups ----------------------------------------------------------

class KeptTaps:
    """One kept group's seven taps at the query grid, slab by slab (module
    docstring)."""

    def __init__(self, vol: torch.Tensor, R: int, S: int, delta: float,
                 bb_min: float, bb_max: float, hoist: bool = False,
                 structured: bool = True, plain: bool = False):
        self.R, self.S, self.delta = R, S, delta
        self.bb = (bb_min, bb_max)
        self.structured = structured
        self.r_in, self.ch = int(vol.shape[0]), int(vol.shape[-1])
        self.kernel = vol.device.type != 'cpu' and not plain
        if self.kernel:
            self.vol = check_volume(vol, 'a kept group')
            return
        # the plain version: the x-lerp plans in the compute dtype, and
        # with ``hoist`` the five z/y variants of the whole volume
        key = (R, self.r_in, S, delta, bb_min, bb_max)
        # the window starts stay host integers (_dyn_slice0's)
        self.los = _host_x_plans(*key)[0]
        self.Ls = device_const(('x_plans',) + key,
                               lambda: _host_x_plans(*key)[1], vol.device,
                               vol.dtype)
        self.hoist = bool(hoist) and structured
        self.vol = vol
        if self.hoist:
            i0, _, w = _axis_plan(R, self.r_in, 0.0, bb_min, bb_max)
            self.ident = bool((w == 0).all() and (i0 == np.arange(R)).all())
            v = zy_variants(vol, self.r_in, R, delta, bb_min, bb_max)
            self.vol = torch.cat([v[key] for (_, key) in TAPS[:5]], dim=-1)

    def slab(self, k: int) -> List[torch.Tensor]:
        if self.kernel:
            return self._slab_kernel(k)
        return self._slab_plain(k)

    def _slab_kernel(self, k: int) -> List[torch.Tensor]:
        R, S, ch, vol = self.R, self.S, self.ch, self.vol
        n = S * R * R
        dev, bf = vol.device, torch.bfloat16
        if self.structured:
            out = [torch.empty(n, 5 * ch, dtype=bf, device=dev),
                   torch.empty(n, ch, dtype=bf, device=dev),
                   torch.empty(n, ch, dtype=bf, device=dev)]
            segs = [(out[0], 5 * ch, t * ch) for t in range(5)] \
                + [(out[1], ch, 0), (out[2], ch, 0)]
        else:
            out = [torch.empty(7, n, ch, dtype=bf, device=dev)]
            segs = [(out[0][t], ch, 0) for t in range(7)]
        groups = [(sx, [(vol, sy, sz)], t)
                  for t, (sx, (sy, sz)) in enumerate(TAPS)]
        _launch(groups, segs, ch, R, (self.r_in,), self.delta, *self.bb,
                k * S, S, out_f32=False)
        return out

    def _slab_plain(self, k: int) -> List[torch.Tensor]:
        R, S, ch, f = self.R, self.S, self.ch, self.vol
        dt = f.dtype
        n = S * R * R
        L7 = self.Ls[k]
        r_max = L7.shape[-1]
        sub = _dyn_slice0(f, self.los[k], r_max)
        if self.hoist:
            if self.ident:
                A5 = _dyn_slice0(f, k * S, S).reshape(n, 5 * ch)
            else:
                A5 = _xlerp(L7[0], sub).to(dt).reshape(n, 5 * ch)
            Vx = sub[..., :ch]
        else:
            variants = zy_variants(sub, self.r_in, R, self.delta, *self.bb)
            if not self.structured:
                # (7, r, R, R, C): each tap's source rows; one batched
                # x-lerp 'tsr,tryzc->tsyzc' (f32), cast, f32 freed
                V7 = torch.stack([variants[key] for (_, key) in TAPS])
                del variants
                A = torch.bmm(L7.float(), V7.reshape(7, r_max, -1).float())
                del V7
                return [A.to(dt).reshape(7, n, ch)]
            Vcat = torch.cat([variants[key] for (_, key) in TAPS[:5]],
                             dim=-1)
            A5 = _xlerp(L7[0], Vcat).to(dt).reshape(n, 5 * ch)
            Vx = variants[(0, 0)]
        Axm = _xlerp(L7[5], Vx).to(dt).reshape(n, ch)
        Axp = _xlerp(L7[6], Vx).to(dt).reshape(n, ch)
        return [A5.contiguous(), Axm, Axp]


# ---- the coarse-projected scales ----------------------------------------------

class CoarseTerm:
    """The coarse-projected scales' summed fc_0 term, slab by slab (module
    docstring)."""

    def __init__(self, taps: Sequence[Sequence[torch.Tensor]], R: int, S: int,
                 delta: float, bb_min: float, bb_max: float,
                 x_range: Tuple[int, int], outside: bool,
                 plain: bool = False):
        self.R, self.S, self.delta = R, S, delta
        self.bb = (bb_min, bb_max)
        self.x0, self.x1 = x_range
        self.outside = bool(outside)
        self.r_ins = tuple(int(P[0].shape[0]) for P in taps)
        self.D = int(taps[0][0].shape[-1])
        self.kernel = taps[0][0].device.type != 'cpu' and not plain
        self.full: Optional[torch.Tensor] = None
        if self.kernel:
            self.taps = [[check_volume(v, 'a projected tap') for v in P]
                         for P in taps]
            if self.outside:
                # the x rows' coarse term once, in the compute dtype
                self.full = self._kernel_rows(self.x0, self.x1 - self.x0,
                                              out_f32=False)
            return
        self._plain_setup(taps)

    def slab(self, k: int) -> torch.Tensor:
        xs, n = k * self.S, self.S * self.R * self.R
        if self.full is not None:
            return self.full[xs - self.x0:xs - self.x0 + self.S].reshape(
                n, -1)
        if self.kernel:
            return self._kernel_rows(xs, self.S, out_f32=True).reshape(n, -1)
        return mm32(self.Lcat[k], self.Ucat.reshape(self.Ucat.shape[0], -1)
                    ).reshape(n, -1)

    def _kernel_rows(self, x0: int, nx: int, out_f32: bool) -> torch.Tensor:
        """(nx, R^2, D) rows x in [x0, x0 + nx), one launch: per scale the
        center group (taps 0-4), then x+ (tap 6) and x- (tap 5), as
        ``XTAPS``."""
        R, D = self.R, self.D
        dev = self.taps[0][0].device
        out = torch.empty(nx, R * R, D, device=dev,
                          dtype=torch.float32 if out_f32 else torch.bfloat16)
        groups = []
        for P in self.taps:
            groups += [(0, [(P[t], *TAPS[t][1]) for t in range(5)], 0),
                       (1, [(P[6], 0, 0)], 0), (-1, [(P[5], 0, 0)], 0)]
        _launch(groups, [(out, D, 0)], D, R, self.r_ins, self.delta,
                *self.bb, x0, nx, out_f32)
        return out

    def _plain_setup(self, taps) -> None:
        """The z/y fold of each scale's taps into its center, x+ and x-
        volumes (R^2 rows each), their concatenation and the banded x-lerp
        plans in the compute dtype; with ``outside`` the x rows' term once,
        cast to the compute dtype."""
        R, S, delta = self.R, self.S, self.delta
        bb_min, bb_max = self.bb
        dt, dev = taps[0][0].dtype, taps[0][0].device
        proj_vols = []
        for P in taps:
            r_in = P[0].shape[0]
            dz = norm_shift(delta, r_in)

            def rz(v, s):
                return resample_axis(v, 2, R, s, bb_min, bb_max)

            def ry(v, s):
                return resample_axis(v, 1, R, s, bb_min, bb_max)

            # TAPS order: t0 center, t1 z-, t2 z+, t3 y-, t4 y+, t5 x-, t6 x+
            Tc = rz(P[0], 0.0) + rz(P[2], dz) + rz(P[1], -dz)
            U0 = ry(Tc, 0.0) + ry(rz(P[4], 0.0), dz) + ry(rz(P[3], 0.0), -dz)
            Uxp = ry(rz(P[6], 0.0), 0.0)
            Uxm = ry(rz(P[5], 0.0), 0.0)
            proj_vols.extend(U.reshape(r_in, R * R, U.shape[-1])
                             for U in (U0, Uxp, Uxm))
        self.Ucat = torch.cat(proj_vols, dim=0)  # (Ktot, R*R, D)
        nslabs = R // S
        r_ins = self.r_ins

        def coarse_plans():
            return np.concatenate(
                [np.transpose(_scan_x_plans_full(R, r_in, S, delta, bb_min,
                                                 bb_max),
                              (0, 2, 1, 3)).reshape(nslabs, S, -1)
                 for r_in in r_ins], axis=-1)

        self.Lcat = device_const(('coarse_x_plans', R, S, delta, bb_min,
                                  bb_max, r_ins), coarse_plans, dev, dt)
        if self.outside:
            x0, x1 = self.x0, self.x1
            k0, k1 = x0 // S, x1 // S
            full = mm32(self.Lcat[k0:k1].reshape(x1 - x0, -1),
                        self.Ucat.reshape(self.Ucat.shape[0], -1)).to(dt)
            self.full = full.reshape(x1 - x0, R * R, -1)
            self.Ucat = None


# ---- measures -----------------------------------------------------------------

def bound_ms(nbytes: float, mem_gbs: float = H100_SXM['mem_gbs']) -> float:
    """Least time in ms on an H100 SXM of moving ``nbytes`` through device
    memory (data-sheet rate): the kernel's bound, its outputs written and
    its volumes read once."""
    return nbytes / (mem_gbs * 1e9) * 1e3


def kept_bytes(n: int, r: int, C: int) -> int:
    """Bytes of one kept group's launch: seven bf16 (n, C) taps written
    and its (r^3, C) bf16 volume read."""
    return 2 * C * (7 * n + r ** 3)


def coarse_bytes(n: int, r_ins: Sequence[int], D: int, out_elem: int = 2
                 ) -> int:
    """Bytes of the coarse term's launch: (n, D) rows of ``out_elem`` bytes
    written and every scale's seven bf16 (r^3, D) tap volumes read."""
    return out_elem * n * D + 2 * 7 * D * sum(r ** 3 for r in r_ins)


def tap_f64(vol: torch.Tensor, shifts: Tuple[int, int, int], R: int,
            x0: int, nx: int, delta: float, bb_min: float = -0.5,
            bb_max: float = 0.5) -> torch.Tensor:
    """Float64 reference of one tap: ``vol`` (r, r, r, C) resampled by the
    shift signs (sx, sy, sz) along x, y and z at the R^3 grid's rows x in
    [x0, x0 + nx), each lerp in float64 with the plans' f32 weights ->
    (nx, R, R, C) float64 on ``vol``'s device."""
    v = vol.double()
    r = int(vol.shape[0])
    for axis, s, lo, cnt in ((0, shifts[0], x0, nx), (1, shifts[1], 0, R),
                             (2, shifts[2], 0, R)):
        i0, i1, w = _axis_plan(R, r, norm_shift(delta * s, r), bb_min,
                               bb_max)
        sl = slice(lo, lo + cnt)
        shape = [1] * 4
        shape[axis] = cnt
        wt = torch.as_tensor(w[sl].astype(np.float64),
                             device=v.device).reshape(shape)
        v0, v1 = (v.index_select(axis, torch.as_tensor(
            i[sl].astype(np.int64), device=v.device)) for i in (i0, i1))
        v = v0 * (1.0 - wt) + v1 * wt
    return v


def f64_errors(got: torch.Tensor, terms, R: int, x0: int, nx: int,
               delta: float, bb_min: float = -0.5, bb_max: float = 0.5,
               chunk: int = 16, rel: float = 2.0 ** -8
               ) -> Tuple[float, float]:
    """(max |got - ref|, the largest use of the tolerance) of ``got``, the
    (nx R^2, C) rows x in [x0, x0 + nx) of a launch, against ``ref``, the
    float64 sum of ``terms`` ((volume, (sx, sy, sz)) pairs, each
    ``tap_f64``), over every element; the tolerance is one round-off of
    |ref| in the output's type (``rel``: 2^-8 for bf16, 2^-24 for f32) plus
    the f32 arithmetic's, rel |ref| + 2^-20 m, with m the same sum over
    |volume|.  Chunks of ``chunk`` x rows."""
    C = got.shape[-1]
    g = got.reshape(nx, R, R, C)
    err = use = 0.0
    for a in range(0, nx, chunk):
        b = min(a + chunk, nx)
        ref = mag = None
        for vol, shifts in terms:
            t = tap_f64(vol[..., :C], shifts, R, x0 + a, b - a, delta, bb_min,
                        bb_max)
            ref = t if ref is None else ref.add_(t)
            t = tap_f64(vol[..., :C].abs(), shifts, R, x0 + a, b - a, delta,
                        bb_min, bb_max)
            mag = t if mag is None else mag.add_(t)
        d = (g[a:b].double() - ref).abs_()
        err = max(err, float(d.max()))
        tol = ref.abs_().mul_(rel).add_(mag.mul_(2.0 ** -20))
        tol.clamp_(min=1e-300)
        use = max(use, float(d.div_(tol).max()))
        del ref, mag, d, tol
    return err, use
