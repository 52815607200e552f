"""K1 and K4: the fused SDF-decoder heads of the dense-grid decode.

- K1 ``fused_stack_head`` replaces the TPU kernel of the same name in
  ``list_tpu/ops/pallas/fused_fc0.py`` (body ``_stack_kernel``); CUDA source
  ``csrc/fused_stack_head.cu``.  The default head (``--use_pallas -1``/2).
- K4 ``fused_fc0_mlp`` replaces ``fused_fc0_mlp`` there (body ``_kernel``);
  CUDA source ``csrc/fused_fc0_mlp.cu``.  The ``--use_pallas 1`` head.

Both sources share their head in ``csrc/fused_head.cuh``; their headers
state the bound on an H100 and what the design does about it.

``fused_stack_head(parts, coarse, percep, qxyz, w1_parts, w1_xyz, b1, w2,
b2, w3, b3, w4, b4)`` -> (n,) f32 raw SDF:

- ``parts``: (n, K_i) compute-dtype structured stack parts; ``w1_parts``
  their (K_i, d1) fc_0 row blocks.
- ``coarse``: None or (n, d1) summed coarse-projected fc_0 term (compute
  dtype when hoisted, f32 in-scan).  ``percep``: (n, d1) projected
  perceptual term.  ``qxyz``: (n, 3) or (n, 8) f32 decoder coordinates.
- Weights in the JAX (in, out) layout: w1_xyz (3, d1), w2 (d1, d2),
  w3 (d2, d3), w4 (d3, 1); biases f32.

``fused_fc0_mlp(stacks, percep, qxyz, w1_scales, w1_xyz, b1, w2, b2, w3,
b3, w4, b4)`` -> (n,) f32 raw SDF, the JAX signature:

- ``stacks``: per-scale t-major (7, n, C_s) compute-dtype tap stacks;
  ``w1_scales`` their (7 * C_s, d1) fc_0 rows in (disp, channel) order.
- ``percep``: (n, d1) projected perceptual term with the coarse term folded
  in, in the compute dtype; ``qxyz`` (n, 3) f32; the tail as above.

A CPU tensor takes the plain version.  ``fused_stack_head_plain`` is the
JAX package's XLA-head math (``list_tpu/ops/dense_grid.py:722-749``) and
``fused_fc0_mlp_plain`` the TPU kernel's, both with the same recasts of
each ReLU output to the operand dtype and f32 accumulation (operands are
upcast to f32 before each product: a product of two bf16 values is exact in
f32, so this equals a bf16 product with f32 accumulation).  A CUDA tensor
launches the kernel, which takes bf16 operands at d1 = 512,
d2 = d3 = 256, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from list_tpu_torch.device import H100_SXM
from list_tpu_torch.ops.cuda import build

SOURCE = 'list_tpu_torch/csrc/fused_stack_head.cu'
REPLACES = 'list_tpu/ops/pallas/fused_fc0.py:208'
MLP_SOURCE = 'list_tpu_torch/csrc/fused_fc0_mlp.cu'
MLP_REPLACES = 'list_tpu/ops/pallas/fused_fc0.py:283'
D1, D2, D3 = 512, 256, 256
# kernel launches since the last reset (launches only, never plain calls):
# K1 and K4
launches = 0
mlp_launches = 0
# K4's staging path of each scale at its last launch, chosen by the C
# launcher: 'rows' (16-byte cp.async of each tap row: C % 8 == 0 with C / 8
# a power of two), 'taps' (C = 1 with n % 8 == 0: 16-byte loads of a tap's
# rows, transposed), both only from a 16-byte aligned base; else 'scalar'
# (2-byte loads, in the same kernel)
STAGING_PATHS = ('scalar', 'rows', 'taps')
mlp_staging: tuple = ()


def _tail(fc0, dt, w2, b2, w3, b3, w4, b4) -> torch.Tensor:
    """ReLU, recast to ``dt``, fc_1, fc_2 and fc_out with f32 sums."""
    h = F.relu(fc0).to(dt)
    h = F.relu(h.float() @ w2.to(dt).float() + b2.float()).to(dt)
    h = F.relu(h.float() @ w3.to(dt).float() + b3.float()).to(dt)
    return (h.float() @ w4.to(dt).float() + b4.float())[:, 0]


def fused_stack_head_plain(parts, coarse, percep, qxyz, w1_parts, w1_xyz,
                           b1, w2, b2, w3, b3, w4, b4) -> torch.Tensor:
    dt = parts[0].dtype
    fc0 = None
    for p, w in zip(parts, w1_parts):
        t = p.float() @ w.to(dt).float()
        fc0 = t if fc0 is None else fc0 + t
    if coarse is not None:
        fc0 = fc0 + coarse.float()
    fc0 = fc0 + percep.float()
    q = qxyz.float()
    wx = w1_xyz.float()
    fc0 = (fc0 + q[:, 0:1] * wx[0] + q[:, 1:2] * wx[1] + q[:, 2:3] * wx[2]
           + b1.float())
    return _tail(fc0, dt, w2, b2, w3, b3, w4, b4)


def fused_fc0_mlp_plain(stacks, percep, qxyz, w1_scales, w1_xyz, b1, w2,
                        b2, w3, b3, w4, b4) -> torch.Tensor:
    """The TPU kernel's order: percep, then each scale's seven per-tap
    products (for C_s = 1 an exact broadcast product), then xyz + b1."""
    dt = stacks[0].dtype
    fc0 = percep.float()
    for st, w in zip(stacks, w1_scales):
        w7 = w.to(dt).float().reshape(7, st.shape[2], -1)
        for t in range(7):
            fc0.addmm_(st[t].float(), w7[t])
    q = qxyz.float()
    wx = w1_xyz.float()
    fc0 += (q[:, 0:1] * wx[0] + q[:, 1:2] * wx[1] + q[:, 2:3] * wx[2]
            + b1.float())
    return _tail(fc0, dt, w2, b2, w3, b3, w4, b4)


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _check_percep_qxyz(what: str, percep: torch.Tensor, qxyz: torch.Tensor,
                       n: int, dev) -> None:
    if percep.device != dev or percep.dtype != torch.bfloat16 \
            or tuple(percep.shape) != (n, D1) or not percep.is_contiguous() \
            or percep.data_ptr() % 16:
        raise ValueError(f'{what}: percep must be contiguous, 16-byte '
                         'aligned bf16 (n, 512) on the parts\' device')
    if qxyz.dtype != torch.float32 or qxyz.device != dev or qxyz.dim() != 2 \
            or qxyz.shape[0] != n or qxyz.shape[1] < 3 \
            or not qxyz.is_contiguous():
        raise ValueError(f'{what}: qxyz must be contiguous f32 (n, 3) or '
                         '(n, 8)')


def _prep_weights(Ks: Sequence[int], w1_parts, w1_xyz, b1, w2, b2, w3, b3,
                  w4, b4, dev):
    bf = torch.bfloat16
    blocks = []
    for K, w in zip(Ks, w1_parts):
        if tuple(w.shape) != (K, D1):
            raise ValueError(f'fused head: W1 block {tuple(w.shape)} '
                             f'does not match operand width {K}')
        kp = -(-K // 16) * 16
        blocks.append(F.pad(w.to(device=dev, dtype=bf), (0, 0, 0, kp - K)))
    w1cat = _aligned(torch.cat(blocks), 32)
    f32 = dict(device=dev, dtype=torch.float32)
    wxyz = _aligned(w1_xyz.to(**f32).reshape(3, D1), 16)
    vecs = [_aligned(b.to(**f32).reshape(-1), 16) for b in (b1, b2, b3, b4)]
    mats = [_aligned(w.to(device=dev, dtype=bf), 32) for w in (w2, w3)]
    if tuple(mats[0].shape) != (D1, D2) or tuple(mats[1].shape) != (D2, D3) \
            or tuple(w4.shape) != (D3, 1):
        raise ValueError('the fused head kernels take d1=512, d2=d3=256 '
                         f'(got w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)},'
                         f' w4 {tuple(w4.shape)})')
    w4v = _aligned(w4.to(device=dev, dtype=bf).reshape(D3), 16)
    return w1cat, wxyz, vecs, mats, w4v


def fused_stack_head(parts: Sequence[torch.Tensor],
                     coarse: Optional[torch.Tensor], percep: torch.Tensor,
                     qxyz: torch.Tensor, w1_parts: Sequence[torch.Tensor],
                     w1_xyz: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     w3: torch.Tensor, b3: torch.Tensor,
                     w4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    global launches
    parts = list(parts)
    if parts[0].device.type == 'cpu':
        return fused_stack_head_plain(parts, coarse, percep, qxyz, w1_parts,
                                      w1_xyz, b1, w2, b2, w3, b3, w4, b4)
    dev = parts[0].device
    n = parts[0].shape[0]
    bf = torch.bfloat16
    for t in parts:
        if t.device != dev or t.dtype != bf or t.dim() != 2 \
                or t.shape[0] != n or not t.is_contiguous():
            raise ValueError('fused_stack_head kernel takes contiguous bf16 '
                             '(n, K) parts on one device')
    _check_percep_qxyz('fused_stack_head', percep, qxyz, n, dev)
    mode = 0
    if coarse is not None:
        mode = {bf: 1, torch.float32: 2}.get(coarse.dtype)
        if mode is None or coarse.device != dev or not coarse.is_contiguous() \
                or tuple(coarse.shape) != (n, D1) or coarse.data_ptr() % 16:
            raise ValueError('fused_stack_head: coarse must be contiguous, '
                             '16-byte aligned (n, 512) bf16 or f32')
    Ks = [int(p.shape[1]) for p in parts]
    w1cat, wxyz, (b1v, b2v, b3v, b4v), (w2m, w3m), w4v = _prep_weights(
        Ks, w1_parts, w1_xyz, b1, w2, b2, w3, b3, w4, b4, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build.load('fused_stack_head')
    fn = lib.fused_stack_head_bf16
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10)
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    ks = (ctypes.c_int * len(parts))(*Ks)
    build.launch(dev, 'fused_stack_head', fn, ptrs, ks, len(parts), n,
                 coarse.data_ptr() if coarse is not None else None, mode,
                 percep.data_ptr(), qxyz.data_ptr(), qxyz.shape[1],
                 w1cat.data_ptr(), w1cat.shape[0], wxyz.data_ptr(),
                 b1v.data_ptr(), w2m.data_ptr(), b2v.data_ptr(),
                 w3m.data_ptr(), b3v.data_ptr(), w4v.data_ptr(),
                 b4v.data_ptr(), out.data_ptr())
    with build.count_lock:
        launches += 1
    return out


def fused_fc0_mlp(stacks: Sequence[torch.Tensor], percep: torch.Tensor,
                  qxyz: torch.Tensor, w1_scales: Sequence[torch.Tensor],
                  w1_xyz: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  w3: torch.Tensor, b3: torch.Tensor,
                  w4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    global mlp_launches, mlp_staging
    stacks = list(stacks)
    if stacks[0].device.type == 'cpu':
        return fused_fc0_mlp_plain(stacks, percep, qxyz, w1_scales, w1_xyz,
                                   b1, w2, b2, w3, b3, w4, b4)
    dev = stacks[0].device
    n = stacks[0].shape[1]
    for t in stacks:
        if t.device != dev or t.dtype != torch.bfloat16 or t.dim() != 3 \
                or t.shape[0] != 7 or t.shape[1] != n \
                or not t.is_contiguous():
            raise ValueError('fused_fc0_mlp kernel takes contiguous bf16 '
                             '(7, n, C) tap stacks on one device')
    _check_percep_qxyz('fused_fc0_mlp', percep, qxyz, n, dev)
    chs = [int(t.shape[2]) for t in stacks]
    w1cat, wxyz, (b1v, b2v, b3v, b4v), (w2m, w3m), w4v = _prep_weights(
        [7 * c for c in chs], w1_scales, w1_xyz, b1, w2, b2, w3, b3, w4, b4,
        dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    fn = build.load('fused_fc0_mlp').fused_fc0_mlp_bf16
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(stacks))(*[t.data_ptr() for t in stacks])
    cs = (ctypes.c_int * len(stacks))(*chs)
    staging = (ctypes.c_int * len(stacks))()
    build.launch(dev, 'fused_fc0_mlp', fn, ptrs, cs, len(stacks), n,
                 percep.data_ptr(), qxyz.data_ptr(), qxyz.shape[1],
                 w1cat.data_ptr(), w1cat.shape[0], wxyz.data_ptr(),
                 b1v.data_ptr(), w2m.data_ptr(), b2v.data_ptr(),
                 w3m.data_ptr(), b3v.data_ptr(), w4v.data_ptr(),
                 b4v.data_ptr(), out.data_ptr(), staging)
    with build.count_lock:
        mlp_launches += 1
        mlp_staging = tuple(STAGING_PATHS[p] for p in staging)
    return out


def bound_ms(n: int, Ks: Sequence[int], coarse_bytes: int = 2,
             q_cols: int = 3, mem_gbs: float = H100_SXM['mem_gbs'],
             bf16_tflops: float = H100_SXM['bf16_tflops']) -> tuple:
    """(least time in ms on an H100 SXM, 'bytes' or 'operations') of a
    fused head over operand widths ``Ks`` (K1: the parts' K_i; K4: 7 * C_s
    per scale, with ``coarse_bytes=0``): parts or stacks,
    coarse (``coarse_bytes`` per element, 0 for none), percep (bf16), qxyz
    (f32, ``q_cols`` columns) and the weights read once, the f32 output
    written once, against the memory rate; the MACs of fc_0 (sum K_i x 512)
    and the tail against the bf16 tensor-core peak (data-sheet rates)."""
    K = sum(Ks)
    per_q = 2 * K + coarse_bytes * D1 + 2 * D1 + 4 * q_cols + 4
    wbytes = 2 * (K * D1 + D1 * D2 + D2 * D3 + D3) + 4 * (3 * D1 + D1 + D2
                                                         + D3 + 1)
    macs = n * (K * D1 + D1 * D2 + D2 * D3 + D3)
    t_b = (n * per_q + wbytes) / (mem_gbs * 1e9) * 1e3
    t_f = 2 * macs / (bf16_tflops * 1e12) * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')
