#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (list_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--report out.json]

Run from the repository root.  Phases (any failure exits non-zero):

1. Read the card: name and power limit from nvidia-smi.
2. Build every CUDA kernel of the paths from ``list_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and the native mesh library.
3. Kernel phase: each kernel against its plain PyTorch version on the card
   at its paths' shapes, with CUDA-event median times of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed here only; the port never calls it): K2 at the inference shapes
   (batch 1) and the train step's forward and dx shapes (batch 8), K3 at
   the train step's shapes, K1 and K4 at the dense decode's; and the
   differentiable conv3x3x3's dx and dk against autograd through the plain
   version.
4. Inference path: the full-width default LIST (vox_res 128) with seeded
   random weights serves ``--requests`` seeded 224x224 images through
   ``LISTExecutor.test(..., eval_pred=True)`` (dense 128^3 SDF -> marching
   cubes -> metrics against a sphere).  A small input (vox_res 32) is
   checked against the CPU plain path, under the default head and under
   ``--use_pallas 1`` (K4).
5. Sweep path: ``test_all`` (the test-split sweep) over the port's
   synthetic dataset (8 shapes, 224x224 renders) at the same full width
   and 128^3, from a torch-format checkpoint of seeded weights, with the
   default band fetch and bf16 wire and ``--eval_pred``: first under
   ``--use_pallas 1`` (the K4 head, 2 launches per mesh), then, after
   deleting 4 of the 8 cached meshes, under the default head (K1) with
   ``--infer_batch 2``; launch counts, the CSV and its metrics asserted
   per sweep.  Before it, the band fetch and the grid fetch of one image
   give identical meshes on the card.
6. Train path: the full-width LIST (vox_res 128, batch 8 x 32,768 queries,
   remat, 4 query chunks) with seeded random weights takes 1 warm and
   3 timed ``LISTExecutor.train`` steps on batches of the synthetic
   dataset; losses, step_s and peak device memory per step, and the
   per-step launch counts asserted.  A small input (vox_res 32, batch 2,
   1,024 queries, full widths) checks one ``LISTExecutor.train`` step's
   losses, every gradient, the updated BatchNorm statistics and the Adam
   update against the CPU plain path.
7. Prints one JSON line of kernel numbers (K2 once per path: per request
   at batch 1, and per train step at batch 8; K4 per mesh of the sweep),
   then the device line.

Every kernel's launch counter is set to 0 just before each path and read
just after it.

``--report PATH`` also writes every number of the run to one JSON file.
"""

import argparse
import copy
import csv
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def card() -> str:
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f'nvidia-smi: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()[0]


def _total(per, unit):
    """Sum of per-shape numbers weighted by each shape's calls per unit."""
    tot = lambda k: sum(r[k] * r['calls'] for r in per)  # noqa: E731
    t_ops = sum(r['bound_ms'] * r['calls'] for r in per
                if r['bound_by'] == 'operations')
    return dict(unit=unit, max_abs_err=max(r['max_abs_err'] for r in per),
                ms=tot('ms'), plain_ms=tot('plain_ms'),
                library_ms=tot('library_ms'), bound_ms=tot('bound_ms'),
                bound_by='operations' if 2 * t_ops >= tot('bound_ms')
                else 'bytes', per_shape=per)


def conv_phase(dev, stencil3d, batch, shapes, unit, plain_reps=5):
    """K2 on (batch, Ci, 128^3) for each (Ci, Co, calls per unit)."""
    g = torch.Generator(device='cpu').manual_seed(11 + batch)
    per = []
    for ci, co, count in shapes:
        x = torch.rand(batch, ci, 128, 128, 128, generator=g).to(dev)
        bound = 1.0 / np.sqrt(27 * ci)
        w = ((torch.rand(co, ci, 3, 3, 3, generator=g) * 2 - 1)
             * bound).to(dev)
        y = stencil3d.conv3x3x3(x, w)
        torch.cuda.synchronize()
        ref = stencil3d.conv3x3x3_plain(x, w)
        err = float((y - ref).abs().max())
        tol = 1e-4 + 1e-4 * float(ref.abs().max())
        ok = bool(torch.isfinite(y).all()) and err <= tol
        b_ms, b_by = stencil3d.bound_ms(tuple(x.shape), co)
        row = dict(shape=f'{ci}->{co} @{batch}x128^3', calls=count,
                   max_abs_err=err, tol=tol, ok=ok,
                   ms=time_ms(lambda: stencil3d.conv3x3x3(x, w), 20),
                   plain_ms=time_ms(
                       lambda: stencil3d.conv3x3x3_plain(x, w), plain_reps,
                       1),
                   library_ms=time_ms(
                       lambda: F.conv3d(x, w, padding=1), 20),
                   bound_ms=b_ms, bound_by=b_by)
        print('kernel conv3x3x3', json.dumps(row), flush=True)
        per.append(row)
        del x, w, y, ref
        torch.cuda.empty_cache()
    if not all(r['ok'] for r in per):
        fail('conv3x3x3 disagrees with its plain version')
    return _total(per, unit)


def dk_phase(dev, stencil3d, batch=8):
    """K3 at the train step's five weight gradients (1->1 three times,
    1->16, 16->16) on (8, Ci, 128^3): against the plain version (tolerance
    1e-4 * max|plain|), twice for bit-identical results, and timed beside
    the plain version and cuDNN's conv3d_weight (TF32 off)."""
    g = torch.Generator(device='cpu').manual_seed(13)
    per = []
    for ci, co, count in ((1, 1, 3), (1, 16, 1), (16, 16, 1)):
        x = torch.rand(batch, ci, 128, 128, 128, generator=g).to(dev)
        dy = torch.randn(batch, co, 128, 128, 128, generator=g).to(dev)
        dk = stencil3d.conv3x3x3_dk(x, dy)
        torch.cuda.synchronize()
        ref = stencil3d.conv3x3x3_dk_plain(x, dy)
        err = float((dk - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        same = bool(torch.equal(stencil3d.conv3x3x3_dk(x, dy), dk))
        ok = bool(torch.isfinite(dk).all()) and err <= tol and same
        b_ms, b_by = stencil3d.bound_ms(tuple(x.shape), co)
        wshape = (co, ci, 3, 3, 3)
        row = dict(shape=f'{ci}->{co} @{batch}x128^3', calls=count,
                   max_abs_err=err, max_abs_plain=float(ref.abs().max()),
                   tol=tol, bit_identical_rerun=same, ok=ok,
                   ms=time_ms(lambda: stencil3d.conv3x3x3_dk(x, dy), 10),
                   plain_ms=time_ms(
                       lambda: stencil3d.conv3x3x3_dk_plain(x, dy), 3, 1),
                   library_ms=time_ms(lambda: torch.nn.grad.conv3d_weight(
                       x, wshape, dy, padding=1), 10),
                   bound_ms=b_ms, bound_by=b_by)
        print('kernel conv3x3x3_dk', json.dumps(row), flush=True)
        per.append(row)
        del x, dy, dk, ref
        torch.cuda.empty_cache()
    if not all(r['ok'] for r in per):
        fail('conv3x3x3_dk disagrees with its plain version or is not '
             'deterministic')
    return _total(per, 'train step (5 launches, batch 8, 128^3)')


def grad_fn_phase(dev, stencil3d, batch=2):
    """The differentiable conv3x3x3 on the card (K2 forward, K2 dx, K3 dk)
    against autograd through the plain version, at 16->16 and 1->16 on
    (2, Ci, 128^3): dx and dk within 1e-4 * max|plain|."""
    g = torch.Generator(device='cpu').manual_seed(14)
    rows = []
    for ci, co in ((16, 16), (1, 16)):
        x0 = torch.rand(batch, ci, 128, 128, 128, generator=g).to(dev)
        w0 = ((torch.rand(co, ci, 3, 3, 3, generator=g) * 2 - 1)
              / np.sqrt(27 * ci)).to(dev)
        r = torch.randn(batch, co, 128, 128, 128, generator=g).to(dev)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = stencil3d.conv3x3x3(x, w)
        if y.grad_fn is None:
            fail('conv3x3x3 on a CUDA tensor has no grad_fn')
        (y * r).sum().backward()
        xp, wp = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        (stencil3d.conv3x3x3_plain(xp, wp) * r).sum().backward()
        torch.cuda.synchronize()
        row = dict(shape=f'{ci}->{co} @{batch}x128^3')
        for name, a, b in (('dx', x.grad, xp.grad), ('dk', w.grad, wp.grad)):
            row[f'{name}_max_abs_err'] = float((a - b).abs().max())
            row[f'{name}_tol'] = 1e-4 * float(b.abs().max())
        row['ok'] = all(row[f'{n}_max_abs_err'] <= row[f'{n}_tol']
                        for n in ('dx', 'dk'))
        print('conv3x3x3 gradients', json.dumps(row), flush=True)
        rows.append(row)
        del x0, w0, r, x, w, y, xp, wp
        torch.cuda.empty_cache()
    if not all(r['ok'] for r in rows):
        fail('conv3x3x3 gradients on the card disagree with autograd '
             'through the plain version')
    return rows


def _uniform(g, dev):
    """Seeded uniform(-scale, scale) tensors on the card."""
    def u(*shape, scale=1.0, dt=torch.float32):
        return ((torch.rand(*shape, generator=g, device=dev) * 2 - 1)
                * scale).to(dt)
    return u


def _head_tail(u, bf):
    """fc_0's xyz rows and bias and the fc_1..fc_out tail (JAX layout)."""
    wxyz, b1 = u(3, 512, scale=1 / np.sqrt(3610)), u(512, scale=0.02)
    w2, b2 = u(512, 256, scale=1 / np.sqrt(512), dt=bf), u(256, scale=0.04)
    w3, b3 = u(256, 256, scale=1 / 16, dt=bf), u(256, scale=0.06)
    w4, b4 = u(256, 1, scale=1 / 16, dt=bf), u(1, scale=0.06)
    return wxyz, b1, w2, b2, w3, b3, w4, b4


def _library_head(a, w1cat, adds, q, tail):
    """The unfused bf16 torch.matmul chain of a fused head."""
    bf = torch.bfloat16
    wxyz, b1, w2, b2, w3, b3, w4, b4 = tail
    h = a @ w1cat
    for t in adds:
        h = h + t
    h = h + q.to(bf) @ wxyz.to(bf) + b1.to(bf)
    h = F.relu(F.relu(h) @ w2 + b2.to(bf))
    h = F.relu(h @ w3 + b3.to(bf))
    return h @ w4 + b4.to(bf)


def _head_row(name, kernel, plain, library, args, shape, bound):
    """A fused head against its plain version (|kernel - plain| <=
    1e-2 + 1e-2 |plain|) and timed beside it and the library chain."""
    y = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = float((y - ref).abs().max())
    tol_ok = bool(((y - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all())
    ok = bool(torch.isfinite(y).all()) and tol_ok
    row = dict(shape=shape, max_abs_err=err, tol='1e-2 + 1e-2*|plain|',
               ok=ok, max_abs_plain=float(ref.abs().max()),
               ms=time_ms(lambda: kernel(*args), 10),
               plain_ms=time_ms(lambda: plain(*args), 3, 1),
               library_ms=time_ms(library, 10), bound_ms=bound[0],
               bound_by=bound[1])
    print(f'kernel {name}', json.dumps(row), flush=True)
    if not ok:
        fail(f'{name} disagrees with its plain version')
    return row


def head_phase(dev, fused_fc0, n: int):
    """K1 at the production dense decode: n = 128^3 queries, nine parts
    (K = 85,17,17,160,32,32,320,64,64), hoisted bf16 coarse term."""
    u = _uniform(torch.Generator(device=dev).manual_seed(12), dev)
    bf = torch.bfloat16
    Ks = (85, 17, 17, 160, 32, 32, 320, 64, 64)
    parts = [u(n, K, dt=bf).abs() for K in Ks]
    w1 = [u(K, 512, scale=1 / np.sqrt(3610), dt=bf) for K in Ks]
    coarse = u(n, 512, scale=0.5, dt=bf)
    percep = u(n, 512, scale=0.5, dt=bf)
    q = u(n, 3)
    tail = _head_tail(u, bf)
    stack, w1cat = torch.cat(parts, 1), torch.cat(w1, 0)
    return _head_row(
        'fused_stack_head', fused_fc0.fused_stack_head,
        fused_fc0.fused_stack_head_plain,
        lambda: _library_head(stack, w1cat, (coarse, percep), q, tail),
        (parts, coarse, percep, q, w1) + tail,
        f'n={n} K={list(Ks)} coarse=bf16',
        fused_fc0.bound_ms(n, Ks, coarse_bytes=2, q_cols=3))


MLP_CHANNELS = (1, 16, 32, 64)  # the kept scales of the default LIST


def mlp_phase(dev, fused_fc0, n: int):
    """K4 at the ``--use_pallas 1`` dense decode: n = 64 x 128^2 queries
    (one slab of 128^3), t-major (7, n, C) tap stacks of channels
    (1, 16, 32, 64), the coarse term already in percep; per launch.  The
    library chain takes the stacks as one (n, 791) operand."""
    u = _uniform(torch.Generator(device=dev).manual_seed(15), dev)
    bf = torch.bfloat16
    stacks = [u(7, n, c, dt=bf).abs() for c in MLP_CHANNELS]
    w1 = [u(7 * c, 512, scale=1 / np.sqrt(3610), dt=bf)
          for c in MLP_CHANNELS]
    percep = u(n, 512, scale=0.5, dt=bf)
    q = u(n, 3)
    tail = _head_tail(u, bf)
    w1cat = torch.cat(w1, 0)

    def library():
        a = torch.cat([s.permute(1, 0, 2).reshape(n, -1) for s in stacks], 1)
        return _library_head(a, w1cat, (percep,), q, tail)

    return _head_row(
        'fused_fc0_mlp', fused_fc0.fused_fc0_mlp,
        fused_fc0.fused_fc0_mlp_plain, library,
        (stacks, percep, q, w1) + tail,
        f'n={n} C={list(MLP_CHANNELS)} t-major',
        fused_fc0.bound_ms(n, [7 * c for c in MLP_CHANNELS], coarse_bytes=0,
                           q_cols=3))


def reset_counts(stencil3d, fused_fc0) -> None:
    stencil3d.launches = stencil3d.dx_launches = stencil3d.dk_launches = 0
    fused_fc0.launches = fused_fc0.mlp_launches = 0


def read_counts(stencil3d, fused_fc0) -> dict:
    return dict(conv3x3x3=stencil3d.launches,
                conv3x3x3_dx=stencil3d.dx_launches,
                conv3x3x3_dk=stencil3d.dk_launches,
                fused_stack_head=fused_fc0.launches,
                fused_fc0_mlp=fused_fc0.mlp_launches)


# K2 per train step: 5 forward + the same 5 recomputed under remat + dx of
# the four convolutions whose input needs a gradient (not conv_0's: its
# input is the occupancy grid); K3: one dk per convolution.
STEP_LAUNCHES = dict(conv3x3x3=14, conv3x3x3_dx=4, conv3x3x3_dk=5,
                     fused_stack_head=0, fused_fc0_mlp=0)
TRAIN_STEPS = 3  # timed, after one warm step


def train_path(ex, batches, stencil3d, fused_fc0):
    """One warm step, then ``len(batches) - 1`` timed LISTExecutor.train
    steps; the launch counters are set to 0 after the warm step and
    checked after every step."""
    ex.train(batches[0])
    torch.cuda.synchronize()
    reset_counts(stencil3d, fused_fc0)
    steps = []
    for i, b in enumerate(batches[1:]):
        before = read_counts(stencil3d, fused_fc0)
        torch.cuda.reset_peak_memory_stats()
        _, losses = ex.train(b)
        after = read_counts(stencil3d, fused_fc0)
        rec = dict(step=i, step_s=ex.timings['step_s'],
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses={k: float(v) for k, v in losses.items()},
                   launches={k: after[k] - before[k] for k in after})
        print('train step', json.dumps(rec), flush=True)
        steps.append(rec)
        if not all(np.isfinite(v) for v in rec['losses'].values()):
            fail(f'train step {i}: a loss is not finite')
        if rec['launches'] != STEP_LAUNCHES:
            fail(f'train step {i}: launches {rec["launches"]}, expected '
                 f'{STEP_LAUNCHES}')
    total = read_counts(stencil3d, fused_fc0)
    print('train path launches', json.dumps(total), flush=True)
    return steps, total


def _rel(a, r) -> float:
    """||a - r|| / ||r|| (L2 over all elements)."""
    return float((a - r).norm()) / max(float(r.norm()), 1e-300)


def card_gradient_check(cfg, model, batch, LISTExecutor, device='cuda'):
    """One ``LISTExecutor.train`` step on ``device`` (f32) against the same
    step on the CPU plain path in f32 and in f64 (the exact reference),
    from the same weights and batch.

    With e(x) = ||x - f64|| / ||f64||, every loss, parameter gradient and
    updated BatchNorm statistic must satisfy
        e(card) <= min(4 * e(cpu f32), 0.1) + floor,
    floor 1e-3 for the losses (one flipped sign of the 2,048 queries moves
    ignore_sdf_accuracy by 4.9e-4), 2e-3 for the gradients and 1e-4 for the
    statistics: the card is held to the CPU's own f32 accuracy, and never
    further than 10% of the reference from it.  A gradient that is zero by
    construction (max|f64| below 1e-9 of the largest gradient: a conv bias
    before a BatchNorm) must stay below 1e-4 of the largest gradient (the
    CPU's f32 rounding leaves up to 1.3e-5 there).  Every gradient must be
    present and finite on the card, and non-zero where the CPU's is.  The
    card's updated parameters must equal the CPU's Adam applied to the
    card's own gradients from the same weights, within
    1e-6 * max|p| + 1e-3 * lr.

    The caller feeds seeded noise images: the synthetic renders' flat
    backgrounds leave channels with a near-zero batch variance, where the
    training BatchNorms amplify f32 rounding into O(1) of many gradients on
    any device, so no f32 gradient could be held to a tolerance there."""
    runs = {}
    for name, dev, dt in (('card', device, torch.float32),
                          ('cpu', 'cpu', torch.float32),
                          ('cpu64', 'cpu', torch.float64)):
        m = copy.deepcopy(model).to(dt)
        ex = LISTExecutor(cfg, m, device=dev)
        _, losses = ex.train(batch)
        f64 = lambda a: None if a is None else a.detach().double().cpu()  # noqa
        runs[name] = dict(
            losses={k: f64(v) for k, v in losses.items()},
            grads={k: f64(p.grad) for k, p in m.named_parameters()},
            stats={k: f64(v) for k, v in m.state_dict().items()
                   if 'running' in k},
            params={k: f64(p) for k, p in m.named_parameters()})
        del ex, m, losses
    card, cpu, ref = (runs[n] for n in ('card', 'cpu', 'cpu64'))
    gmax = max(float(r.abs().max()) for r in ref['grads'].values())
    bad, ratio, vox, capped = [], {}, {}, 0
    for part, floor in (('losses', 1e-3), ('grads', 2e-3), ('stats', 1e-4)):
        for k, r in ref[part].items():
            c, g = cpu[part][k], card[part][k]
            if g is None or not bool(torch.isfinite(g).all()) or (
                    float(c.abs().max()) > 0 and float(g.abs().max()) == 0):
                bad.append((k, 'missing, not finite or zero on the card'))
                continue
            if part == 'grads' and float(r.abs().max()) < 1e-9 * gmax:
                err, tol = float(g.abs().max()) / gmax, 1e-4
            else:
                err, data = _rel(g, r), 4 * _rel(c, r)
                capped += data > 0.1
                tol = min(data, 0.1) + floor
            ratio[k] = err / tol
            if k.startswith('vox_encoder.') and part == 'grads':
                vox[k] = dict(err=err, tol=tol)
            if err > tol:
                bad.append((k, err, tol))
    # Adam on the card: the CPU's optimizer on the card's gradients
    adam = LISTExecutor(cfg, copy.deepcopy(model), device='cpu')
    opt = adam.init_optimizer()
    for k, p in adam.model.named_parameters():
        g = card['grads'][k]
        p.grad = None if g is None else g.float()
    opt.step()
    adam_err = 0.0
    for k, p in adam.model.named_parameters():
        want = p.detach().double()
        err = float((card['params'][k] - want).abs().max())
        tol = 1e-6 * float(want.abs().max()) + 1e-3 * cfg.lr
        adam_err = max(adam_err, err / tol)
        if err > tol:
            bad.append((k, 'Adam update', err, tol))
    rec = dict(ok=not bad, bad=bad[:20],
               losses={n: {k: float(v) for k, v in runs[n]['losses'].items()}
                       for n in runs},
               worst_err_over_tol=sorted(
                   ((r, k) for k, r in ratio.items()), reverse=True)[:3],
               tolerances_at_the_cap=capped,
               adam_worst_err_over_tol=adam_err,
               vox_encoder_params=len(vox),
               vox_encoder_nonzero_on_card=sum(
                   float(card['grads'][k].abs().max()) > 0 for k in vox),
               vox_encoder_rel=vox)
    print('card gradient check', json.dumps(rec), flush=True)
    return rec


SWEEP_SHAPES = 8  # the synthetic test split
SWEEP_DROPPED = (1, 2, 3, 5)  # cached meshes deleted before the 2nd sweep


def sweep_run(cfg, label, stencil3d, fused_fc0):
    """One ``test_all`` sweep on the card: the whole wall (model build and
    checkpoint load included), the device phase (from the first device
    call's start to the CSV) and fresh meshes per second of it, each device
    call's encode_s/decode_s, peak device memory and the launch counts (set
    to 0 just before the sweep and read just after); fails unless the CSV
    holds a row of finite metrics per shape and the mean row."""
    from list_tpu_torch.infer.pipeline import test_all
    from list_tpu_torch.train import LISTExecutor
    calls, starts = [], []
    real = {k: getattr(LISTExecutor, k)
            for k in ('predict_grid', 'predict_grid_batch')}

    def timed(k):
        def call(self, imgs, *a, **kw):
            starts.append(time.perf_counter())
            out = real[k](self, imgs, *a, **kw)
            calls.append(dict(images=len(imgs), **self.timings))
            return out
        return call

    for k in real:
        setattr(LISTExecutor, k, timed(k))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(stencil3d, fused_fc0)
    t0 = time.perf_counter()
    try:
        csv_path = test_all(cfg)
    finally:
        for k, f in real.items():
            setattr(LISTExecutor, k, f)
    t1 = time.perf_counter()
    wall = t1 - t0
    counts = read_counts(stencil3d, fused_fc0)
    if csv_path is None:
        fail(f'sweep {label}: no checkpoint loaded or no CSV written')
    with open(csv_path) as f:
        header, *rows = list(csv.reader(f))
    vals = np.asarray([r[2:] for r in rows], np.float64)
    fresh = sum(c['images'] for c in calls)
    device_phase = t1 - starts[0] if starts else float('nan')
    rec = dict(sweep=label, wall_s=wall, device_phase_s=device_phase,
               fresh_meshes=fresh,
               fresh_meshes_per_s=fresh / device_phase,
               device_calls=calls, launches=counts,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               csv=os.path.relpath(csv_path, HERE), columns=header[2:],
               mean_row=dict(zip(header[2:], vals[-1].tolist())))
    print('sweep', json.dumps(rec), flush=True)
    if len(rows) != SWEEP_SHAPES + 1 or rows[-1][1] != 'Mean':
        fail(f'sweep {label}: {len(rows)} CSV rows, expected '
             f'{SWEEP_SHAPES} and the mean row')
    if vals.size == 0 or not np.isfinite(vals).all():
        fail(f'sweep {label}: a metric in the CSV is missing or not finite')
    return rec


def band_check(ex, img):
    """The band fetch against the grid fetch of one image on the card
    (bf16 wire): identical marching-cubes vertices and faces."""
    from list_tpu_torch.ops import band
    from list_tpu_torch.utils.meshing import generate_mesh
    full = ex.predict_grid(img, fetch_mode='grid')
    out = ex.predict_grid(img, fetch_mode='band', device_out=True)
    buf = band.band_to_numpy(out.band)
    a = generate_mesh(full, ex.bb_min, ex.bb_max)
    b = generate_mesh(band.fetch_grid_f32(out), ex.bb_min, ex.bb_max)
    return dict(count=int(buf[-1]), cap=band.band_cap(full.size),
                overflow=int(buf[-1]) > band.band_cap(full.size),
                band_mb=buf.nbytes / 1e6, vertices=len(a[0]),
                identical=bool(np.array_equal(a[0], b[0])
                               and np.array_equal(a[1], b[1]))), full


def sweep_phase(args, stencil3d, fused_fc0):
    """The test-split sweep at full width and 128^3 (module docstring,
    phase 5)."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    from list_tpu_torch.train.checkpoints import save_checkpoint
    root = os.path.join(HERE, 'build', 'chip_smoke_sweep')
    shutil.rmtree(root, ignore_errors=True)
    base = dict(model='network.models.LIST',
                dataset='datasets.Datasets.Synthetic', vox_res=128,
                sdf_scale=10.0, eval_pred=True, output_dir=root + '/',
                exp_name='sweep')
    cfg = default_config(use_pallas=1, **base)

    # the checkpoint: seeded weights, fc_out's bias set so the first test
    # image's grid has its median at zero
    torch.manual_seed(args.seed)
    model = LIST.from_config(cfg)
    ex = LISTExecutor(default_config(**base), model)
    img = SyntheticSDFDataset(cfg, 'test').get_testdata(
        'synthetic', '0', 0)['rgb_image']
    shift = float(np.median(ex.predict_grid(img, fetch_mode='grid'))) \
        * cfg.sdf_scale
    with torch.no_grad():
        model.sdf_decoder.fc_out.bias -= shift
    ckpt = os.path.join(cfg.checkpoint_dir, cfg.test_checkpoint)
    save_checkpoint(0, model, 0.5, ckpt)
    print(f'sweep checkpoint {os.path.relpath(ckpt, HERE)}, fc_out bias '
          f'shifted by {-shift:.6g}', flush=True)

    # the band fetch on the card: the sweep's weights, then weights whose
    # surface fits the band (3% of the grid negative), which must not
    # overflow
    bands = []
    for q in (None, 0.03):
        rec, full = band_check(ex, img)
        if q is not None:
            rec['negative_quantile'] = q
        print('band fetch on the card', json.dumps(rec), flush=True)
        bands.append(rec)
        if not rec['identical']:
            fail('the band fetch and the grid fetch give different meshes')
        if q is None:
            with torch.no_grad():
                model.sdf_decoder.fc_out.bias -= float(
                    np.quantile(full, 0.03)) * cfg.sdf_scale
    if bands[-1]['overflow']:
        fail('the band overflowed on a grid that fits it')
    del ex, model
    torch.cuda.empty_cache()

    first = sweep_run(cfg, '--use_pallas 1', stencil3d, fused_fc0)
    want = dict(conv3x3x3=5 * SWEEP_SHAPES, conv3x3x3_dx=0, conv3x3x3_dk=0,
                fused_stack_head=0, fused_fc0_mlp=2 * SWEEP_SHAPES)
    if first['launches'] != want or first['fresh_meshes'] != SWEEP_SHAPES:
        fail(f'sweep --use_pallas 1: launches {first["launches"]} for '
             f'{first["fresh_meshes"]} fresh meshes, expected {want}')

    out = os.path.dirname(os.path.join(HERE, first['csv']))
    for i in SWEEP_DROPPED:
        os.remove(os.path.join(out, 'synthetic', str(i), '00_pred.obj'))
    cfg2 = default_config(infer_batch=2, **base)
    second = sweep_run(cfg2, '--use_pallas -1 --infer_batch 2', stencil3d,
                       fused_fc0)
    groups = {i // 2 for i in SWEEP_DROPPED}
    want = dict(conv3x3x3=5 * len(groups), conv3x3x3_dx=0, conv3x3x3_dk=0,
                fused_stack_head=len(SWEEP_DROPPED), fused_fc0_mlp=0)
    if second['launches'] != want \
            or second['fresh_meshes'] != len(SWEEP_DROPPED):
        fail(f'sweep --infer_batch 2: launches {second["launches"]} for '
             f'{second["fresh_meshes"]} fresh meshes, expected {want}')
    return dict(sweeps=[first, second], band=bands)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--report', default=None,
                    help='also write the run\'s numbers to this JSON file')
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke run needs '
             'an NVIDIA GPU')
    sys.path.insert(0, HERE)
    try:
        from list_tpu_torch import native
        from list_tpu_torch.config import default_config
        from list_tpu_torch.data import SyntheticSDFDataset, collate
        from list_tpu_torch.models import LIST
        from list_tpu_torch.ops.cuda import (KERNEL_SOURCES, build,
                                             fused_fc0, stencil3d)
        from list_tpu_torch.ops.dense_grid import dense_grid_sdf
        from list_tpu_torch.train import LISTExecutor
        from list_tpu_torch.utils.meshio import make_icosphere
    except ImportError as e:
        fail(f'the list_tpu_torch package is not beside chip_smoke.py ({e})')

    t_start = time.perf_counter()
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    card_line = card()
    print(card_line, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'devices {torch.cuda.device_count()}', flush=True)

    # ---- build: nvcc per kernel source in parallel, g++ beside them ----
    t0 = time.perf_counter()
    nat = threading.Thread(target=native.have_native)
    nat.start()
    try:
        logs = build.build_all(KERNEL_SOURCES)
    except RuntimeError as e:
        fail(str(e))
    nat.join()
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'ptxas {name}: {line.strip()}', flush=True)
    if not native.have_native():
        fail('the native mesh library did not build')
    print(f'build_s {time.perf_counter() - t0:.1f}', flush=True)

    # ---- kernel phase -----------------------------------------------------
    with torch.inference_mode():
        conv = conv_phase(dev, stencil3d, 1, ((1, 1, 3), (1, 16, 1),
                                              (16, 16, 1)),
                          'request (5 launches, batch 1, 128^3)')
        head = head_phase(dev, fused_fc0, 128 ** 3)
        torch.cuda.empty_cache()
        mlp_row = mlp_phase(dev, fused_fc0, 64 * 128 ** 2)
        # per mesh: two slabs of 64 x 128^2 queries
        mlp = _total([dict(mlp_row, calls=2)],
                     'mesh (2 launches of n = 1,048,576)')
        torch.cuda.empty_cache()
        # a train step: forward 1->1 x3, 1->16, 16->16, twice (remat), and
        # dx 1->1 x2, 16->1, 16->16
        conv_train = conv_phase(dev, stencil3d, 8, ((1, 1, 8), (1, 16, 2),
                                                    (16, 16, 3), (16, 1, 1)),
                                'train step (14 launches, batch 8, 128^3)',
                                plain_reps=2)
        dk = dk_phase(dev, stencil3d)
    grads_on_card = grad_fn_phase(dev, stencil3d)
    torch.cuda.empty_cache()

    # ---- path phase: full-width LIST at 128^3 ------------------------------
    torch.manual_seed(args.seed)
    cfg = default_config(vox_res=128, sdf_scale=10.0, fetch_mode='grid')
    model = LIST.from_config(cfg)
    cpu_model = copy.deepcopy(model)
    ex = LISTExecutor(cfg, model)  # device defaults to cuda
    rng = np.random.RandomState(args.seed)
    imgs = [rng.rand(1, 224, 224, 3).astype(np.float32)
            for _ in range(args.requests)]
    gt = make_icosphere(radius=0.3)
    # weight choice: centre fc_out's bias on the first grid's median so the
    # random field has a zero crossing
    g0 = ex.predict_grid(imgs[0])
    shift = float(np.median(g0)) * cfg.sdf_scale
    with torch.no_grad():
        model.sdf_decoder.fc_out.bias -= shift
        cpu_model.sdf_decoder.fc_out.bias -= shift
    print(f'fc_out bias shifted by {-shift:.6g}', flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(stencil3d, fused_fc0)
    requests = []
    for i, img in enumerate(imgs):
        np.random.seed(args.seed + i)
        t_req = time.perf_counter()
        (mesh, values), score = ex.test({'rgb_image': img, 'gt_mesh': gt},
                                        eval_pred=True)
        rec = dict(request=i, wall_s=time.perf_counter() - t_req,
                   **ex.timings, vertices=len(mesh.vertices),
                   faces=len(mesh.faces), metrics=score)
        print('request', json.dumps(rec), flush=True)
        requests.append(rec)
        if values.shape != (128, 128, 128) or not np.isfinite(values).all():
            fail(f'request {i}: grid shape {values.shape} or not finite')
        if rec['vertices'] <= 0 or rec['faces'] <= 0:
            fail(f'request {i}: empty mesh')
        if not score or not all(np.isfinite(v) for v in score.values()):
            fail(f'request {i}: metrics missing or not finite: {score}')
    launches = read_counts(stencil3d, fused_fc0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print('inference path launches', json.dumps(launches),
          f'peak_device_gb {peak_gb:.2f}', flush=True)
    if launches != dict(conv3x3x3=5 * args.requests, conv3x3x3_dx=0,
                        conv3x3x3_dk=0,
                        fused_stack_head=launches['fused_stack_head'],
                        fused_fc0_mlp=0):
        fail(f'inference path launches {launches}, expected conv3x3x3 '
             f'{5 * args.requests} and no dx or dk')
    if launches['fused_stack_head'] < args.requests:
        fail('fused_stack_head was not launched for every request')

    # ---- small input against the CPU plain path ---------------------------
    small = default_config(vox_res=32, sdf_scale=10.0, fetch_mode='grid')
    m_gpu = copy.deepcopy(cpu_model)
    m_gpu.vox_res = cpu_model.vox_res = 32
    a = LISTExecutor(small, m_gpu).predict_grid(imgs[0],
                                                fetch_dtype='float32')
    b = LISTExecutor(small, cpu_model, device='cpu').predict_grid(
        imgs[0], fetch_dtype='float32')
    ref_err = float(np.abs(a - b).max())
    ref_tol = 2e-3 + 2e-2 * float(np.abs(b).max())
    print(f'small input (vox_res 32) card vs CPU plain: max_abs_err '
          f'{ref_err:.3g} tol {ref_tol:.3g}', flush=True)
    if not (np.isfinite(a).all() and ref_err <= ref_tol):
        fail('the card disagrees with the CPU plain path on a small input')
    # the same under --use_pallas 1: K4 on the card (one slab of 32^3),
    # fused_fc0_mlp_plain on the CPU (whose executor would pick head 0)
    before = fused_fc0.mlp_launches
    a1 = LISTExecutor(default_config(vox_res=32, sdf_scale=10.0,
                                     fetch_mode='grid', use_pallas=1),
                      m_gpu).predict_grid(imgs[0], fetch_dtype='float32')
    k4_small = fused_fc0.mlp_launches - before
    with torch.inference_mode():
        enc = cpu_model.eval().encode(torch.as_tensor(imgs[0]))
        b1 = (dense_grid_sdf(cpu_model.sdf_decoder, enc['vox_feat'],
                             enc['feat_l2'], enc['trans_mat'], 32, slab=32,
                             compute_dtype=torch.bfloat16,
                             bb_min=small.bb_min, bb_max=small.bb_max,
                             use_pallas=1) / small.sdf_scale).numpy()
    k4_err = float(np.abs(a1 - b1).max())
    k4_tol = 2e-3 + 2e-2 * float(np.abs(b1).max())
    print(f'small input (vox_res 32, --use_pallas 1) card vs CPU plain: '
          f'max_abs_err {k4_err:.3g} tol {k4_tol:.3g}, K4 launches '
          f'{k4_small}', flush=True)
    if k4_small != 1:
        fail(f'--use_pallas 1 at vox_res 32 launched K4 {k4_small} times, '
             'expected 1')
    if not (np.isfinite(a1).all() and k4_err <= k4_tol):
        fail('the card disagrees with the CPU plain path on a small input '
             'under --use_pallas 1')
    del ex, model, cpu_model, m_gpu
    torch.cuda.empty_cache()

    # ---- sweep path: test_all at full width, 128^3 ------------------------
    sweep = sweep_phase(args, stencil3d, fused_fc0)
    torch.cuda.empty_cache()

    # ---- train path: full-width LIST, batch 8 x 32,768 queries, 128^3 -----
    tcfg = default_config(vox_res=128, train_batch_size=8,
                          sample_point_density=32768, sdf_scale=10.0)
    t0 = time.perf_counter()
    ds = SyntheticSDFDataset(tcfg, 'train', n_shapes=8)
    batches = [collate([ds[i] for i in range(8)])
               for _ in range(TRAIN_STEPS + 1)]
    print(f'train data {time.perf_counter() - t0:.1f} s', flush=True)
    torch.manual_seed(args.seed)
    tex = LISTExecutor(tcfg, LIST.from_config(tcfg))
    tex.init_optimizer()
    steps, train_launches = train_path(tex, batches, stencil3d, fused_fc0)
    del tex, batches
    torch.cuda.empty_cache()

    # ---- small train step against the CPU plain path ----------------------
    gcfg = default_config(vox_res=32, train_batch_size=2,
                          sample_point_density=1024, sdf_scale=10.0)
    gds = SyntheticSDFDataset(gcfg, 'train', n_shapes=2)
    gbatch = collate([gds[0], gds[1]])
    # seeded noise images: see card_gradient_check
    gbatch['rgb_image'] = np.random.RandomState(args.seed + 5).rand(
        *gbatch['rgb_image'].shape).astype(np.float32)
    torch.manual_seed(args.seed + 1)
    gcheck = card_gradient_check(gcfg, LIST.from_config(gcfg), gbatch,
                                 LISTExecutor, 'cuda')
    if not gcheck['ok']:
        fail(f'one train step on the card disagrees with the CPU plain '
             f'path: {json.dumps(gcheck["bad"])}')

    kernels = [
        dict(name='conv3x3x3', route='cuda', source=stencil3d.SOURCE,
             replaces=stencil3d.REPLACES, launches=launches['conv3x3x3'],
             per=conv['unit'], max_abs_err=conv['max_abs_err'],
             ms=conv['ms'], plain_ms=conv['plain_ms'],
             bound_ms=conv['bound_ms'], bound_by=conv['bound_by'],
             library_ms=conv['library_ms']),
        dict(name='conv3x3x3_train', route='cuda', source=stencil3d.SOURCE,
             replaces=stencil3d.REPLACES,
             launches=train_launches['conv3x3x3'],
             dx_launches=train_launches['conv3x3x3_dx'],
             per=conv_train['unit'], max_abs_err=conv_train['max_abs_err'],
             ms=conv_train['ms'], plain_ms=conv_train['plain_ms'],
             bound_ms=conv_train['bound_ms'],
             bound_by=conv_train['bound_by'],
             library_ms=conv_train['library_ms']),
        dict(name='conv3x3x3_dk', route='cuda', source=stencil3d.DK_SOURCE,
             replaces=stencil3d.DK_REPLACES,
             launches=train_launches['conv3x3x3_dk'], per=dk['unit'],
             max_abs_err=dk['max_abs_err'], ms=dk['ms'],
             plain_ms=dk['plain_ms'], bound_ms=dk['bound_ms'],
             bound_by=dk['bound_by'], library_ms=dk['library_ms']),
        dict(name='fused_stack_head', route='cuda', source=fused_fc0.SOURCE,
             replaces=fused_fc0.REPLACES,
             launches=launches['fused_stack_head'],
             per='request (n = 128^3)',
             max_abs_err=head['max_abs_err'], ms=head['ms'],
             plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
             bound_by=head['bound_by'], library_ms=head['library_ms']),
        dict(name='fused_fc0_mlp', route='cuda', source=fused_fc0.MLP_SOURCE,
             replaces=fused_fc0.MLP_REPLACES,
             launches=sweep['sweeps'][0]['launches']['fused_fc0_mlp'],
             per=mlp['unit'], max_abs_err=mlp['max_abs_err'], ms=mlp['ms'],
             plain_ms=mlp['plain_ms'], bound_ms=mlp['bound_ms'],
             bound_by=mlp['bound_by'], library_ms=mlp['library_ms']),
    ]
    report = dict(card=card_line, kind=kind, kernels=kernels,
                  conv_inference=conv, conv_train=conv_train, dk=dk,
                  conv_gradients_on_card=grads_on_card, head=head, mlp=mlp,
                  requests=requests, peak_device_gb=peak_gb,
                  small_input_err=ref_err, small_input_k4_err=k4_err,
                  sweep=sweep, train_steps=steps,
                  train_launches=train_launches, gradient_check=gcheck,
                  total_s=time.perf_counter() - t_start)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(report, f, indent=1, default=float)
    print(f'total_s {report["total_s"]:.1f}', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
