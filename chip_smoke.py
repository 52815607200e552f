#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (list_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--report out.json]
    python3 chip_smoke.py --cards 4 [--report out.json]

Run from the repository root.  Phases (any failure exits non-zero):

1. Read the card: name and power limit from nvidia-smi.
2. Build every CUDA kernel of the paths from ``list_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and the native mesh library.
3. Kernel phase: each kernel against its plain PyTorch version on the card
   at its paths' shapes, with CUDA-event median times of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed here only; the port never calls it): K2 at the inference shapes
   (batch 1) and the train step's forward and dx shapes (batch 8), K3 at
   the train step's shapes, K1 and K4 at the dense decode's (K4's
   staging path per scale printed, and K4 also held on the same inputs
   one bf16 into their buffers and cut to a ragged n, off its vector
   paths); and the differentiable conv3x3x3's dx and dk against autograd
   through the plain version.  The BatchNorm path
   (``ops/cuda/batch_norm.py``) at the voxel encoder's shapes that it
   takes (1, 16 and 32 channels): the training forward and backward at
   batch 8 and the eval forward at batch 1 against float64 within a few
   f32 round-offs, bit-identical reruns, launches counted, timed beside
   cuDNN and ``torch.var_mean`` + ``F.batch_norm``.  The perceptual sample
   (``ops/cuda/percep.py``) at a 128^3 slab and C = 512: one launch, held
   to float64 at the plain version's pixels, timed beside the plain
   version and ``F.grid_sample`` (DISN's expanded views timed too).  The
   voxel work (``ops/cuda/voxel.py``) at a 128^3 slab: each kept group's
   seven taps and the hoisted coarse term, one ``voxel_taps`` launch each,
   held to float64 over every element, timed beside the plain version.
4. Inference path: the full-width default LIST (vox_res 128) with seeded
   random weights serves ``--requests`` seeded 224x224 images through
   ``LISTExecutor.test(..., eval_pred=True)`` (dense 128^3 SDF -> marching
   cubes -> metrics against a sphere), one perceptual sample a slab and
   the voxel kernel's launches (3 kept groups and 1 coarse term) of each
   request asserted.  Then no waits: after a warm call
   each, an encode, a 128^3 and a 256^3 dense decode and a stage-2 train
   step (batch 8 x 32,768 queries, ``--remat_save_samples 1``) run under
   ``torch.cuda.set_sync_debug_mode('error')`` and an upload probe: any
   synchronizing call (the step's batch upload and closing
   synchronization aside) or host array made a tensor fails the run (the
   constants stay on the card, ``list_tpu_torch/ops/consts.py``); each of
   those decodes' launches asserted, the 256^3 one (slabs of 8, K1) held to
   the plain head within 1e-2 + 1e-2 |plain|, and 4 chunks of the 128^3
   grid through the chunked decoder launch no kernel.  A small
   input (vox_res 32) is checked against the CPU plain path, under the
   default head and under ``--use_pallas 1`` (K4).
5. Sweep path: ``test_all`` (the test-split sweep) over the port's
   synthetic dataset (8 shapes, 224x224 renders) at the same full width
   and 128^3, from a torch-format checkpoint of seeded weights, with the
   default band fetch and bf16 wire and ``--eval_pred``: first under
   ``--use_pallas 1`` (the K4 head, 2 launches per mesh), then, after
   deleting 4 of the 8 cached meshes, under the default head (K1) with
   ``--infer_batch 2``; launch counts, the CSV and its metrics asserted
   per sweep.  Before it, the band fetch and the grid fetch of one image
   give identical meshes on the card.  The sweep's device calls return
   without waiting for the card and the fetch pool copies each result on
   a side stream once its CUDA event has passed; each call's encode_s and
   decode_s come from its events, and each ``sweep`` line prints the
   first and the later decode_s and, beside this run's device phase and
   fresh meshes/s, those of the synchronized fetch it replaced.
6. Train path: the full-width LIST (vox_res 128, batch 8 x 32,768 queries,
   remat, 4 query chunks) with seeded random weights takes 1 warm and
   3 timed ``LISTExecutor.train`` steps on batches of the synthetic
   dataset; losses, step_s and peak device memory per step, and the
   per-step launch counts asserted; then ``train_multi`` over 2 of the
   batches, twice a step's launches and finite losses.  The same cell at
   ``--remat_save_samples`` 0, 1 and 2 from the same weights and batches
   (1 warm and 2 timed steps each, step_s and peak memory as the port
   runs by default; then 2 steps each with deterministic algorithms,
   where the losses, parameters and BatchNorm statistics must agree with
   level 0's within the CPU remat test's tolerances).  A small input (vox_res 32,
   batch 2, 1,024 queries, full widths) checks one ``LISTExecutor.train``
   step's losses, every gradient, the updated BatchNorm statistics and the
   Adam update against the CPU plain path.
7. Overfit gate (``tools/torch_overfit_chip.py``): the same full-width
   LIST trains 400 steps at batch 4 x 32,768 queries on one analytic
   sphere, then ``predict_grid`` (K1, bf16 wire, band fetch), marching
   cubes and the containment IoU on 200,000 points; the gate (finite
   losses, the final sdf_loss under half the first, more than 10
   vertices, IoU > 0.7) and the launches of every step (K2 14, of which
   dx 4, K3 5) and of the mesh (K2 5, K1 1, the perceptual sample 1,
   voxel_taps 4) asserted; one ``overfit``
   line.
8. Training driver: the full-width CoarseNet (ResNet18 at 224^2, TreeGCN
   to 4,096 points) takes 1 warm and 3 timed ``CoarseNetExecutor.train``
   steps at batch 16 (step_s, peak memory, the Chamfer loss), and one small
   step is held against the CPU in f32 and f64; then ``trainer.train``
   runs the two-stage recipe on the synthetic dataset with a testlist of
   two shapes: CoarseNet at batch 8 for 1 epoch, ``split_coarse``, and the
   full-width LIST warm-started from it at vox_res 128 (batch 8 x 32,768
   queries, remat, 4 query chunks, ``--eval_pred``) for 1 epoch.  Launch
   counts asserted per step (K2 14, K3 5) and per testlist shape (K2 5,
   K1 1), the checkpoint files the driver writes, and the frozen
   submodules bit-identical to the split after the warm-started epoch.
9. Pix3D phase, under ``build/chip_smoke_pix3d/``: 8 synthetic shapes in
   a raw Pix3D tree (raw meshes, one 224x224 render a shape, pix3d.json,
   train and test splits of 8 and 4 images) go through the port's
   preprocessing at the published settings (``preprocess.run``, 50,000
   surface points, sigmas 0.003 0.01 0.07; host seconds a mesh), then its
   farthest-point sampling on the card at k = 5,000 (synchronized seconds
   a shape; indices against the same function on the CPU, the covering
   radii within 1e-6 relative) and ``run_fps``; then ``trainer.train``
   runs the Pix3D two-stage recipe on the preprocessed tree: CoarseNet
   ``-e coarse_prediciton_Pix3D`` at batch 8 for 1 epoch,
   ``split_coarse``, the full-width LIST ``-e list_Pix3D --warm_start`` at
   vox_res 128 (batch 8 x 32,768 queries, remat, 4 query chunks) for 1
   epoch with a testlist of two images and ``--eval_pred`` (launches per
   step and per testlist image, checkpoint files and frozen submodules
   asserted as in phase 7); and ``test_all`` sweeps the 4 test images from
   stage 2's weights (fc_out's bias centred on the first test image's
   grid), K2 5 and K1 1 a fresh image and one CSV row per image, named
   ``<model folder>_<image>``.  One ``pix3d`` JSON line sums it up.
10. Distributed phase (``list_tpu_torch.parallel``), under
   ``build/chip_smoke_dist/``: two ranks on the one card joined by gloo
   (NCCL refuses two ranks on one GPU) take 1 warm and 2 timed
   data-parallel steps of the full-width LIST at a global batch of
   8 x 32,768 queries (4 a rank, remat, 4 query chunks; step_s, peak
   memory and K2 14 / K3 5 launches a step per rank), after which their
   parameters, BatchNorm statistics and Adam moments must be
   bit-identical; one 2-rank step of the small input (vox_res 32, global
   batch 4) is held to the 1-process step by ``card_gradient_check``'s
   tolerances; then ``test_all`` with ``--multihost 1`` sweeps each
   rank's strided 4 of the 8 synthetic test shapes (phase 5's checkpoint,
   default head, band fetch, ``--eval_pred``) into ``<cat>_p{rank}.csv``,
   whose rows must be those of phase 5's default-head 1-process sweep
   within the sweep tolerance (rtol 7e-2, atol 2e-2).  A 1-rank NCCL
   group's small step must be bit-identical to the step with no group
   (deterministic algorithms on, in a process of its own); in the same
   process ``--checkify`` must leave that step bit-identical, and a NaN
   written into its image must raise FloatingPointError and leave the
   parameters, BatchNorm statistics, Adam moments and step as they were.
   ``evaluation/evaluate_torch.py`` and ``evaluate_gather_torch.py`` score
   and merge the sharded sweep's meshes, and ``predict_grid`` with the
   decode split over two row ranges on the card must give the unsplit
   grid with 2 K1 launches (each timed).
11. Prints one JSON line of kernel numbers (K2 and BatchNorm once per
    path: per request at batch 1, and per train step at batch 8; K4 per
    mesh of the sweep; the perceptual sample per slab of 128^3; the voxel
    work per 128^3 mesh;
    ``driver_launches`` and ``pix3d_launches``: the warm-started LIST
    epoch's counts on the synthetic and the Pix3D data), then the device
    line.

Every kernel's launch counter is set to 0 just before each path and read
just after it, and held to the launch table (``launches``,
``step_launches``, ``decode_launches``).

``--report PATH`` also writes every number of the run to one JSON file.

The multi-card mode, ``python3 chip_smoke.py --cards 4`` (exits non-zero
unless the machine has that many cards; ``--report`` as above), runs
instead of the phases above, with cuda:0 the current device throughout:

1. Every card's nvidia-smi line; the kernels built once, while a process
   of its own writes a synthetic ShapeNet tree of 48 shapes a card (one
   224x224 view a shape) with its 128^3 occupancy caches.
2. On cuda:1 .. N-1: K2 at the train step's shapes, K3, K1 and K4 at the
   kernel phase's shapes, the BatchNorm path, the perceptual sample, the
   voxel work and the differentiable conv3x3x3 (K2's dx and K3 through its backward),
   each held to its plain version within the kernel phase's tolerances
   and 1e-2 + 1e-2 |plain|, timed on its card, every kernel launched;
   the current device must stay cuda:0.
3. The dense decode split over cuda:0 .. N-1 (``--mesh_shape N`` and
   ``--mesh_shape 1 N``) from one 128^3 encoding, at 128^3 and 256^3,
   against one card's: the grid bit for bit, K1's launches, and the
   decode's host-clock seconds and each card's CUDA-event seconds on one
   card, split as the executor dispatches it (from one host thread, the
   cards' slabs in turns), and split with a host thread a card; one more
   split decode under the sync debug mode and the upload probe, as in the
   no-waits phase; ``predict_grid``,
   ``predict_grid_batch`` and ``test`` under both mesh shapes; then
   ``test_all`` over the 8 synthetic test shapes on one card and under
   both mesh shapes, every row held to one card's.
4. N NCCL ranks (this script with ``--card_rank``, rank r on cuda:r,
   logs ``build/chip_smoke_cards/rank<r>.log``): ``train_torch.main`` with
   ``--multihost 1`` on the tree at the stage-2 recipe (128^3, 32,768
   queries, remat, ``--remat_save_samples 1``, 4 query chunks) at 2 and 8
   a card and stage 1 at 16 a card (step_s, peak memory and launches per
   step and rank; the ranks' parameters, BatchNorm statistics and Adam
   moments bit-identical after each run), the small step at a global
   batch of 4 (held to one process by ``card_gradient_check``), and
   ``infer_torch.main`` with ``--multihost 1`` over the 8 test shapes
   (each rank's ``_p{rank}.csv`` rows held to the one-card sweep's); then
   the offline evaluation of their meshes.
5. One full-width stage-2 step (after a warm one) and one 128^3 mesh
   through ``LISTExecutor(..., device='cuda:N-1')`` in this process.

It prints a ``cards`` JSON line, then the device line with ``count`` N.
"""

import argparse
import collections
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

from list_tpu_torch.device import card, time_ms
from list_tpu_torch.models.list_model import DEFAULT_IM_ENC_LAYERS
from list_tpu_torch.ops.cuda import (batch_norm, launch_counts,
                                     reset_launch_counts)

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


# ---- the launch table -------------------------------------------------------
# Which kernel each path launches and how often, worked out from the default
# LIST's encoder layers, the BatchNorm routing rule and the decode's plan:
# every launch check of this script takes its expectation from these
# functions, so a new kernel or a re-routed BatchNorm changes one of them.

def launches(on_card: bool = True, **counts) -> dict:
    """Every counter of ``launch_counts()`` with its launches in ``counts``
    (0 where not given) on the card, and 0 on the CPU, where the wrappers
    take their plain versions."""
    want = dict.fromkeys(launch_counts(), 0)
    unknown = sorted(set(counts) - set(want))
    if unknown:
        raise KeyError(f'no launch counter named {unknown}')
    if on_card:
        want.update(counts)
    return want


def full_res_convs() -> int:
    """K2 calls of one VoxelEncoder2 forward: every convolution before its
    first pooling (conv_0, conv_1, conv_2, then conv_3 and conv_3_0)."""
    n = len(DEFAULT_IM_ENC_LAYERS) - 1
    return min(n, 3) + (2 if n > 3 else 0)


def routed_norms(batch: int, R: int) -> list:
    """The channels of each VoxelEncoder2 BatchNorm that ``routes`` sends
    to the kernels at ``batch`` and vox_res R: bn_0 and bn_1 at R^3, then
    bn_l (l > 2) at (R / 2^(l - 3))^3."""
    layers = DEFAULT_IM_ENC_LAYERS
    return [layers[l + 1] for l in range(len(layers) - 1) if l != 2
            and batch_norm.routes(5, torch.float32, layers[l + 1],
                                  batch * (R >> max(0, l - 3)) ** 3)]


def step_launches(on_card: bool = True, batch: int = 8, R: int = 128,
                  remat: bool = True, group: bool = False) -> dict:
    """One LISTExecutor.train step of ``batch`` items at vox_res R: the
    encoder's full-resolution convs forward (again under remat), dx of
    each but conv_0 (its input is the occupancy grid) and dk of each; the
    routed BatchNorms' backward, and the forward (again under remat) of
    those the kernels normalize.  Under a process group of more than one
    rank (``group``) BatchNorm takes the global batch's moments in plain
    PyTorch (models/norm.py) and launches none of its kernels."""
    n = full_res_convs()
    norms = [] if group else routed_norms(batch, R)
    fwd = sum(batch_norm.normalizes(c) for c in norms)
    return launches(on_card, conv3x3x3=n * (2 if remat else 1) + n - 1,
                    conv3x3x3_dx=n - 1, conv3x3x3_dk=n,
                    batch_norm=fwd * (2 if remat else 1),
                    batch_norm_bwd=len(norms))


def voxel_launches(head: int = 2, coarse_proj: int = 16) -> tuple:
    """(kept launches a slab, whether a coarse term) of LIST's dense decode
    from a 128^3 encoding: the VoxelEncoder2 features (conv_2's at 128^3,
    then conv_l's at 128 / 2^(l - 3)) above ``coarse_proj`` are kept, one
    ``voxel_taps`` launch a same-resolution group (head 0 or 2) or a scale
    (head 1) a slab; those at or below it make the coarse term."""
    n = len(DEFAULT_IM_ENC_LAYERS) - 1
    res = [128] + [128 >> (l - 3) for l in range(3, n)]
    kept = [r for r in res if r > coarse_proj]
    if not kept:
        kept = res
    return (len(kept) if head == 1 else len(set(kept)),
            len(kept) < len(res))


def decode_launches(on_card: bool = True, R: int = 128, slab=128,
                    head: int = 2, meshes: int = 1, encodes=(),
                    cards: int = 1) -> dict:
    """``meshes`` dense R^3 decodes by the plan (``slab``, ``head``) that
    ``LISTExecutor._dense_plan`` gives, split over ``cards``: a slab
    launches one perceptual sample, its head (2: K1, 1: K4; 0, the plain
    head, no kernel) and ``voxel_launches`` kept groups, and the coarse
    term one launch a card at R <= 128 (hoisted), else one a slab; the
    chunked decoder (slab None) nothing; beside one 128^3 encode for
    each batch size in ``encodes``: its full-resolution convolutions and
    its routed BatchNorms (eval)."""
    per = meshes * (R // slab) if slab else 0
    kept, coarse = voxel_launches(head)
    hoisted = meshes * cards if R <= 128 else per
    return launches(on_card, conv3x3x3=len(encodes) * full_res_convs(),
                    fused_stack_head=per if head == 2 else 0,
                    fused_fc0_mlp=per if head == 1 else 0,
                    batch_norm=sum(len(routed_norms(b, 128))
                                   for b in encodes),
                    percep_sample=per,
                    voxel_taps=per * kept + (hoisted if coarse and slab
                                             else 0))


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
        torch.cuda.synchronize(dev)
        ref = stencil3d.conv3x3x3_plain(x, w)
        err = float((y - ref).abs().max())
        tol = 1e-4 + 1e-4 * float(ref.abs().max())
        ok = bool(torch.isfinite(y).all()) and err <= tol
        b_ms, b_by = stencil3d.bound_ms(tuple(x.shape), co)
        row = dict(shape=f'{ci}->{co} @{batch}x128^3', calls=count,
                   max_abs_err=err, tol=tol, ok=ok,
                   within_head_tol=_within_head_tol(y, ref),
                   ms=time_ms(lambda: stencil3d.conv3x3x3(x, w), 20,
                              device=dev),
                   plain_ms=time_ms(
                       lambda: stencil3d.conv3x3x3_plain(x, w), plain_reps,
                       1, device=dev),
                   library_ms=time_ms(
                       lambda: F.conv3d(x, w, padding=1), 20, device=dev),
                   bound_ms=b_ms, bound_by=b_by)
        print('kernel conv3x3x3', json.dumps(row), flush=True)
        per.append(row)
        del x, w, y, ref
        torch.cuda.empty_cache()
    if not all(r['ok'] for r in per):
        fail('conv3x3x3 disagrees with its plain version')
    return _total(per, unit)


# K2 in a train step at batch 8 (Ci, Co, launches): forward 1->1 x3,
# 1->16, 16->16, twice (remat), and dx 1->1 x2, 16->1, 16->16
TRAIN_CONV_SHAPES = ((1, 1, 8), (1, 16, 2), (16, 16, 3), (16, 1, 1))
TRAIN_CONV_UNIT = 'train step (14 launches, batch 8, 128^3)'


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
        torch.cuda.synchronize(dev)
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
                   within_head_tol=_within_head_tol(dk, ref),
                   ms=time_ms(lambda: stencil3d.conv3x3x3_dk(x, dy), 10,
                              device=dev),
                   plain_ms=time_ms(
                       lambda: stencil3d.conv3x3x3_dk_plain(x, dy), 3, 1,
                       device=dev),
                   library_ms=time_ms(lambda: torch.nn.grad.conv3d_weight(
                       x, wshape, dy, padding=1), 10, device=dev),
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
        torch.cuda.synchronize(dev)
        row = dict(shape=f'{ci}->{co} @{batch}x128^3')
        for name, a, b in (('dx', x.grad, xp.grad), ('dk', w.grad, wp.grad)):
            row[f'{name}_max_abs_err'] = float((a - b).abs().max())
            row[f'{name}_tol'] = 1e-4 * float(b.abs().max())
            row[f'{name}_within_head_tol'] = _within_head_tol(a, b)
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


# The BatchNorm kernels' main-path shapes (C, R, BatchNorms of that shape):
# the voxel encoder's bn_0 and bn_1, bn_3 and bn_4, at batch 8 in a train
# step (each forward twice under remat, one backward) and at batch 1 in a
# request (eval, once each)
BN_SHAPES = ((1, 128, 2), (16, 128, 1), (32, 64, 1))
BN_U = 2.0 ** -24  # f32 round-off
# limits in BN_U * max|float64|: the kernels' forward 16 and dx 64
# (tests/test_torch_cuda.py); cuDNN's training forward (above one channel)
# 64, where it reads about 20 on these inputs (PERF.md).  dweight and
# dbias are each channel's sum of M terms, which may cancel to near 0:
# theirs in BN_U * the channel's sum of |terms|, limit 1
BN_LIMITS = dict(kernel=16, cudnn=64, backward=64, sums=1)


def _bn_inputs(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    return (3.0 + torch.randn(shape, device=dev, generator=g),
            1.0 + 0.5 * torch.randn(c, device=dev, generator=g),
            torch.randn(c, device=dev, generator=g),
            torch.randn(shape, device=dev, generator=g))


def _launched(before) -> dict:
    """The BatchNorm launches since ``before`` (a ``launch_counts()``)."""
    after = launch_counts()
    return {k: after[k] - before[k] for k in ('batch_norm', 'batch_norm_bwd')}


def _bn_ulps(pairs) -> dict:
    return {k: float((got.double() - ref).abs().max()
                     / (BN_U * ref.abs().max())) for k, got, ref in pairs}


def bn_phase(dev, batch_norm, reps=10):
    """The BatchNorm path on the card at its main-path shapes (BN_SHAPES):
    the training forward and backward as ``BatchNorm`` runs them
    (``batch_norm_train`` and autograd) at batch 8, and the eval forward at
    batch 1, against the plain versions in float64 within BN_LIMITS; two
    runs bit-identical; the launches of each call counted.  Timed beside
    cuDNN (``F.batch_norm`` and its backward), the module's training
    forward before the kernels (``torch.var_mean`` for the running
    statistics, then ``F.batch_norm``) and the plain versions; a train
    row's times are a BatchNorm's in one step (two forwards, one
    backward; ``var_mean_ms``: that forward, cuDNN's recompute and cuDNN's
    backward).  Returns the train step's and the request's totals."""
    eps = batch_norm.EPS
    train, evals = [], []
    for c, r, calls in BN_SHAPES:
        shape = (8, c, r, r, r)
        x, w, b, dy = _bn_inputs(shape, dev, 17 + c)
        runs = []
        before = launch_counts()
        for _ in range(2):
            xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
            y, mean, var = batch_norm.batch_norm_train(xr, wr, br)
            y.backward(dy)
            runs.append((y.detach(), mean, var, xr.grad, wr.grad, br.grad))
            del xr, wr, br, y
        counts = _launched(before)
        same = all(torch.equal(p, q) for p, q in zip(*runs))
        x64, w64, b64, dy64 = (t.double() for t in (x, w, b, dy))
        y64, m64, v64 = batch_norm.batch_norm_train_plain(x64, w64, b64)
        dx64, dw64, db64 = batch_norm.batch_norm_backward_plain(
            x64, dy64, w64, m64, torch.rsqrt(v64 + eps))
        fwd_limit = BN_LIMITS['kernel' if batch_norm.normalizes(c)
                              else 'cudnn']
        ulps = _bn_ulps(zip(('y', 'mean', 'var', 'dx'), runs[0],
                            (y64, m64, v64, dx64)))
        view = (1, c, 1, 1, 1)
        terms = dict(dweight=(dy64 * (x64 - m64.view(view))).abs().sum(
            [0, 2, 3, 4]) * torch.rsqrt(v64 + eps), dbias=dy64.abs().sum(
                [0, 2, 3, 4]))
        for k, got, ref in (('dweight', runs[0][4], dw64),
                            ('dbias', runs[0][5], db64)):
            ulps[k] = float(((got.double() - ref).abs()
                             / (BN_U * terms[k])).max())
        err = max(float((g.double() - ref).abs().max()) for g, ref in zip(
            runs[0], (y64, m64, v64, dx64, dw64, db64)))
        del runs, x64, dy64, y64, dx64, terms
        torch.cuda.empty_cache()
        limit = dict(y=fwd_limit, mean=fwd_limit, var=fwd_limit,
                     dx=BN_LIMITS['backward'], dweight=BN_LIMITS['sums'],
                     dbias=BN_LIMITS['sums'])
        ok = same and counts['batch_norm'] == 2 * batch_norm.normalizes(c) \
            and counts['batch_norm_bwd'] == 2 and all(
                v <= limit[k] for k, v in ulps.items())
        dims = [0, 2, 3, 4]
        _, mean, _, rstd = batch_norm._forward_train(x, w, b)
        xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
        y_cudnn = F.batch_norm(xr, None, None, wr, br, True, 0.0, eps)

        def cudnn_fwd():
            return F.batch_norm(x, None, None, w, b, True, 0.0, eps)

        def var_mean_fwd():
            torch.var_mean(x, dim=dims, correction=0)
            return cudnn_fwd()

        with torch.no_grad():
            fwd = time_ms(lambda: batch_norm.batch_norm_train(x, w, b), reps,
                          device=dev)
            lib_fwd = time_ms(cudnn_fwd, reps, device=dev)
            var_mean = time_ms(var_mean_fwd, reps, device=dev)
            plain_fwd = time_ms(lambda: batch_norm.batch_norm_train_plain(
                x, w, b), 3, 1, device=dev)
        bwd = time_ms(lambda: batch_norm._backward(x, dy, w, mean, rstd,
                                                   True), reps, device=dev)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            y_cudnn, (xr, wr, br), dy, retain_graph=True), reps, device=dev)
        plain_bwd = time_ms(lambda: batch_norm.batch_norm_backward_plain(
            x, dy, w, mean, rstd), 3, 1, device=dev)
        bound = batch_norm.bound_ms(shape)
        row = dict(shape=f'{c} ch @8x{r}^3', calls=calls,
                   forward='kernels' if batch_norm.normalizes(c)
                   else 'cuDNN', launches=counts, bit_identical_rerun=same,
                   ulps=ulps, max_abs_err=err, ok=ok,
                   forward_ms=fwd, backward_ms=bwd, cudnn_forward_ms=lib_fwd,
                   cudnn_backward_ms=lib_bwd, var_mean_forward_ms=var_mean,
                   ms=2 * fwd + bwd, library_ms=2 * lib_fwd + lib_bwd,
                   var_mean_ms=var_mean + lib_fwd + lib_bwd,
                   plain_ms=2 * plain_fwd + plain_bwd,
                   bound_ms=2 * bound['train'] + bound['backward'],
                   bound_by='bytes')
        print('kernel batch_norm train', json.dumps(row), flush=True)
        train.append(row)
        del x, dy, xr, y_cudnn
        torch.cuda.empty_cache()

        shape = (1, c, r, r, r)
        x, w, b, _ = _bn_inputs(shape, dev, 19 + c)
        rm = 3.0 + 0.1 * torch.randn(c, device=dev)
        rv = 0.5 + torch.rand(c, device=dev)
        with torch.inference_mode():
            before = launch_counts()
            ys = [batch_norm.batch_norm_eval(x, rm, rv, w, b)
                  for _ in range(2)]
            counts = _launched(before)
            ref = batch_norm.batch_norm_eval_plain(
                *(t.double() for t in (x, rm, rv, w, b)))
            ulps = _bn_ulps([('y', ys[0], ref)])
            same = bool(torch.equal(*ys))
            row = dict(shape=f'{c} ch @1x{r}^3', calls=calls,
                       launches=counts, bit_identical_rerun=same, ulps=ulps,
                       max_abs_err=float((ys[0].double() - ref).abs().max()),
                       ok=same and counts['batch_norm'] == 2
                       and ulps['y'] <= BN_LIMITS['kernel'],
                       ms=time_ms(lambda: batch_norm.batch_norm_eval(
                           x, rm, rv, w, b), reps, device=dev),
                       library_ms=time_ms(lambda: F.batch_norm(
                           x, rm, rv, w, b, False, 0.0, eps), reps,
                           device=dev),
                       plain_ms=time_ms(
                           lambda: batch_norm.batch_norm_eval_plain(
                               x, rm, rv, w, b), 3, 1, device=dev),
                       bound_ms=batch_norm.bound_ms(shape)['eval'],
                       bound_by='bytes')
        print('kernel batch_norm eval', json.dumps(row), flush=True)
        evals.append(row)
        del x, ys, ref
        torch.cuda.empty_cache()
    if not all(r['ok'] for r in train + evals):
        fail('the BatchNorm path disagrees with its plain version, is not '
             'deterministic or launched other than expected')
    step = _total(train, 'train step (batch 8; 4 forward launches of the '
                  'one-channel kernels, 4 backward)')
    step['var_mean_ms'] = sum(r['var_mean_ms'] * r['calls'] for r in train)
    return step, _total(evals, 'request (4 launches, batch 1)')


# the perceptual sample's checked slab: LIST's learned-camera stand-in
# (pixels inside the map, depth near 1), as tests/test_torch_cuda.py's
PERCEP_CAMERA = [[60.0, 1.0, 0.1], [2.0, -60.0, 0.05], [0.5, 0.3, 0.02],
                 [68.0, 68.0, 1.0]]


def percep_coords(R, dev, order='list'):
    """One R^3 slab's query coordinates as the decodes build them: LIST's
    (2 z, 2 y, 2 x), materialised; DISN's (x, y, z), expanded views."""
    step = 1.0 / (R - 1)
    ar = torch.arange(R, dtype=torch.float32, device=dev) * step - 0.5
    fx = ar[:, None, None].expand(R, R, R)
    fy = ar[None, :, None].expand(R, R, R)
    fz = ar[None, None, :].expand(R, R, R)
    return (2.0 * fz, 2.0 * fy, 2.0 * fx) if order == 'list' \
        else (fx, fy, fz)


def _percep_f64(percep, flat, t, ps, outs, chunk=2 ** 17):
    """(max |out - ref| for each of ``outs``, the per-element bound's
    worst use for the first, max |ref|) over every query and channel, in
    chunks of queries: ref the bilinear in float64 at the plain version's
    f32 pixels; the bound 2^-8 |ref| + 2^-20 max |map| (one bf16 round-off
    of the f32 bilinear)."""
    ms = percep.PERCEP_MAP
    xpix, ypix = percep.pixel_coords(t, *ps)
    x, y = xpix.reshape(-1).double(), ypix.reshape(-1).double()
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=ms - 1), (y0 + 1).clamp(max=ms - 1)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    m = flat.double()
    floor = 2.0 ** -20 * float(m.abs().max())
    errs, use, ref_max = [0.0] * len(outs), 0.0, 0.0
    for a in range(0, x.numel(), chunk):
        b = slice(a, a + chunk)
        ref = ((1 - wy[b]) * ((1 - wx[b]) * m[y0[b] * ms + x0[b]]
                              + wx[b] * m[y0[b] * ms + x1[b]])
               + wy[b] * ((1 - wx[b]) * m[y1[b] * ms + x0[b]]
                          + wx[b] * m[y1[b] * ms + x1[b]]))
        for i, out in enumerate(outs):
            e = (out[b].double() - ref).abs()
            errs[i] = max(errs[i], float(e.max()))
            if i == 0:
                use = max(use, float((e / (2.0 ** -8 * ref.abs()
                                           + floor)).max()))
        ref_max = max(ref_max, float(ref.abs().max()))
    return errs, use, ref_max


def _percep_check(percep, flat, t, ps, dev):
    """One kernel call on the coordinates ``ps`` held to float64 and to
    the plain version over all n x C: launched once, finite, each element
    within one bf16 round-off of float64 (plus 2^-20 max |map|), its
    largest error at most the plain version's plus one round-off of
    max |f64|, and max |kernel - plain| within both (the card test's
    bounds, ``tests/test_torch_cuda.py`` ``-k percep``)."""
    bf = torch.bfloat16
    before = percep.launches
    got = percep.percep_sample(flat, t, *ps, bf)
    torch.cuda.synchronize(dev)
    launched = percep.launches - before
    plain = percep.percep_sample_plain(flat, t, *ps, bf)
    (err, plain_err), use, ref_max = _percep_f64(percep, flat, t, ps,
                                                 (got, plain))
    scale = float(flat.abs().max())
    gap = float((got.float() - plain.float()).abs().max())
    ok = (launched == 1 and bool(torch.isfinite(got.float()).all())
          and use <= 1.0 and err <= plain_err + 2.0 ** -8 * ref_max
          and gap <= plain_err + 2.0 ** -8 * ref_max + 2.0 ** -20 * scale)
    del got, plain
    return dict(launches=launched, max_abs_err=gap, f64_err=err,
                plain_f64_err=plain_err, f64_bound_use=use, ok=ok)


def percep_phase(dev, percep, R=128, C=512):
    """The perceptual sample (``ops/cuda/percep.py``) at a 128^3 slab and
    C = 512, in LIST's materialised coordinates and in DISN's stride-0
    expanded views (``_percep_check``: one launch each, held to float64 and
    to the plain version over every query and channel), timed beside the
    plain version and one ``F.grid_sample`` over the channels-first bf16
    map (border padding, corners aligned), which the port never calls."""
    ms = percep.PERCEP_MAP
    bf = torch.bfloat16
    g = torch.Generator(device='cpu').manual_seed(13)
    flat = torch.randn(ms * ms, C, generator=g).to(dev, bf)
    t = torch.tensor(PERCEP_CAMERA, device=dev)
    ps = percep_coords(R, dev)
    views = percep_coords(R, dev, 'disn')
    checks = dict(list=_percep_check(percep, flat, t, ps, dev),
                  disn_views=_percep_check(percep, flat, t, views, dev))
    ok = all(c['ok'] for c in checks.values())
    xpix, ypix = percep.pixel_coords(t, *ps)
    grid = (torch.stack([xpix, ypix], -1).reshape(1, 1, -1, 2)
            * (2.0 / (ms - 1)) - 1.0).to(bf)
    img = flat.t().reshape(1, C, ms, ms).contiguous()

    def library():
        return F.grid_sample(img, grid, mode='bilinear',
                             padding_mode='border', align_corners=True)
    row = dict(shape=f'n={R ** 3} C={C} (LIST order; DISN views checked '
                     'and timed too)', calls=1,
               launches=sum(c['launches'] for c in checks.values()),
               max_abs_err=max(c['max_abs_err'] for c in checks.values()),
               checks=checks,
               tol='per element <= 2^-8 |f64| + 2^-20 max|map|; f64 err <= '
                   'plain f64 err + 2^-8 max|f64|; |kernel - plain| <= plain '
                   'f64 err + 2^-8 max|f64| + 2^-20 max|map|; all n x C',
               ok=ok,
               ms=time_ms(lambda: percep.percep_sample(flat, t, *ps, bf),
                          20, device=dev),
               ms_disn_views=time_ms(lambda: percep.percep_sample(
                   flat, t, *views, bf), 20, device=dev),
               plain_ms=time_ms(lambda: percep.percep_sample_plain(
                   flat, t, *ps, bf), 3, 1, device=dev),
               library_ms=time_ms(library, 10, device=dev),
               library='F.grid_sample bfloat16',
               bound_ms=percep.bound_ms(R ** 3, C), bound_by='bytes')
    print('kernel percep_sample', json.dumps(row), flush=True)
    if not ok:
        fail('percep_sample disagrees with float64 or the plain version '
             'beyond its tolerance, or launched other than once a call')
    return row


# LIST's dense decode at 128^3 from a 128^3 encoding: each kept group's
# (source resolution, channels), and the coarse term's projected scales
VOXEL_GROUPS = ((128, 17), (64, 32), (32, 64))
VOXEL_COARSE = (16, 8)


def voxel_phase(dev, voxel, R=128, D=512, delta=0.0722):
    """The voxel work (``ops/cuda/voxel.py``) at a 128^3 slab on volumes
    of N(0, 1) in bf16: each kept group's seven taps (``VOXEL_GROUPS``,
    the structured parts) and the coarse term hoisted over the grid (two
    scales of seven (r^3, 512) taps), one launch each, held to float64
    over every element (``f64_errors``: within one bf16 round-off, 2^-8
    |f64| + 2^-20 of the same sum over |volumes|) with the plain version's
    error beside, and timed beside the plain version (CUDA events, few
    repetitions)."""
    bf = torch.bfloat16
    g = torch.Generator(device='cpu').manual_seed(17)
    n, per, ok = R ** 3, [], True
    for r, C in VOXEL_GROUPS:
        vol = torch.randn(r, r, r, C, generator=g).to(dev, bf)
        kt = voxel.KeptTaps(vol, R, R, delta, -0.5, 0.5)
        pl = voxel.KeptTaps(vol, R, R, delta, -0.5, 0.5, plain=True)
        before = voxel.launches
        got = kt.slab(0)
        torch.cuda.synchronize(dev)
        launched, vec = voxel.launches - before, voxel.vec_path
        plain = pl.slab(0)
        cols = [(got[0], plain[0], t * C) for t in range(5)] \
            + [(got[1], plain[1], 0), (got[2], plain[2], 0)]
        errs = [(voxel.f64_errors(a[:, o:o + C], [(vol, (sx, sy, sz))], R,
                                  0, R, delta),
                 voxel.f64_errors(b[:, o:o + C], [(vol, (sx, sy, sz))], R,
                                  0, R, delta))
                for (a, b, o), (sx, (sy, sz)) in zip(cols, voxel.TAPS)]
        gap = max(float((a[:, o:o + C].float() - b[:, o:o + C].float())
                        .abs().max()) for a, b, o in cols)
        del got, plain, cols
        row = dict(shape=f'{r}^3 x {C} -> n={n} x 7 taps', launches=launched,
                   vec=vec, f64_err=max(e[0][0] for e in errs),
                   f64_use=max(e[0][1] for e in errs),
                   plain_f64_err=max(e[1][0] for e in errs),
                   plain_f64_use=max(e[1][1] for e in errs),
                   max_abs_err=gap,
                   ms=time_ms(lambda: kt.slab(0), 5, 1, device=dev),
                   plain_ms=time_ms(lambda: pl.slab(0), 2, 1, device=dev),
                   bound_ms=voxel.bound_ms(voxel.kept_bytes(n, r, C)))
        ok = ok and launched == 1 and row['f64_use'] <= 1.0
        per.append(row)
        del kt, pl, vol
    taps = [[torch.randn(r, r, r, D, generator=g).to(dev, bf)
             for _ in range(7)] for r in VOXEL_COARSE]
    before = voxel.launches
    got = voxel.CoarseTerm(taps, R, R, delta, -0.5, 0.5, (0, R), True)
    torch.cuda.synchronize(dev)
    launched, vec = voxel.launches - before, voxel.vec_path
    plain = voxel.CoarseTerm(taps, R, R, delta, -0.5, 0.5, (0, R), True,
                             plain=True)
    terms = [(P[t], (sx, sy, sz)) for P in taps
             for t, (sx, (sy, sz)) in enumerate(voxel.TAPS)]
    err, use = voxel.f64_errors(got.slab(0), terms, R, 0, R, delta)
    perr, puse = voxel.f64_errors(plain.slab(0), terms, R, 0, R, delta)
    gap = float((got.slab(0).float() - plain.slab(0).float()).abs().max())
    del got, plain
    row = dict(shape=f'{"^3 + ".join(map(str, VOXEL_COARSE))}^3 x 7 taps x '
                     f'{D} -> n={n} x {D}', launches=launched, vec=vec,
               f64_err=err, f64_use=use, plain_f64_err=perr,
               plain_f64_use=puse, max_abs_err=gap,
               ms=time_ms(lambda: voxel.CoarseTerm(
                   taps, R, R, delta, -0.5, 0.5, (0, R), True), 5, 1,
                   device=dev),
               plain_ms=time_ms(lambda: voxel.CoarseTerm(
                   taps, R, R, delta, -0.5, 0.5, (0, R), True, plain=True),
                   2, 1, device=dev),
               bound_ms=voxel.bound_ms(voxel.coarse_bytes(n, VOXEL_COARSE,
                                                          D)))
    ok = ok and launched == 1 and use <= 1.0
    per.append(row)
    del taps
    out = dict(unit=f'mesh ({len(per)} launches, a 128^3 slab)',
               launches=sum(r['launches'] for r in per),
               ms=sum(r['ms'] for r in per),
               plain_ms=sum(r['plain_ms'] for r in per),
               bound_ms=sum(r['bound_ms'] for r in per), bound_by='bytes',
               max_abs_err=max(r['max_abs_err'] for r in per),
               f64_use=max(r['f64_use'] for r in per),
               tol='per element <= 2^-8 |f64| + 2^-20 f64 of |volumes| '
                   '(f64_use <= 1), all n x C', ok=ok, per_shape=per)
    print('kernel voxel_taps', json.dumps(out), flush=True)
    if not ok:
        fail('voxel_taps disagrees with float64 beyond one bf16 round-off, '
             'or launched other than once a call')
    return out


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


def _within_head_tol(y, ref) -> bool:
    """|y - ref| <= 1e-2 + 1e-2 |ref| everywhere (the fused heads'
    tolerance)."""
    return bool(((y - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all())


def _head_check(kernel, plain, args):
    """(output, max |kernel - plain|, within 1e-2 + 1e-2 |plain| and
    finite, max |plain|) of a fused head on the card."""
    y = kernel(*args)
    torch.cuda.synchronize(y.device)
    ref = plain(*args)
    err = float((y - ref).abs().max())
    return (y, err, bool(torch.isfinite(y).all()) and _within_head_tol(y, ref),
            float(ref.abs().max()))


def _head_row(name, kernel, plain, library, args, shape, bound,
              after=dict):
    """A fused head against its plain version (|kernel - plain| <=
    1e-2 + 1e-2 |plain|) and timed beside it and the library chain;
    ``after()``'s keys, read right after the checked launch, join the
    row."""
    y, err, ok, max_plain = _head_check(kernel, plain, args)
    dev = y.device
    row = dict(shape=shape, **after(), max_abs_err=err,
               tol='1e-2 + 1e-2*|plain|', ok=ok, max_abs_plain=max_plain,
               ms=time_ms(lambda: kernel(*args), 10, device=dev),
               plain_ms=time_ms(lambda: plain(*args), 3, 1, device=dev),
               library_ms=time_ms(library, 10, device=dev),
               bound_ms=bound[0], bound_by=bound[1])
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

    kernel, plain = fused_fc0.fused_fc0_mlp, fused_fc0.fused_fc0_mlp_plain
    args = (stacks, percep, q, w1) + tail
    row = _head_row(
        'fused_fc0_mlp', kernel, plain, library, args,
        f'n={n} C={list(MLP_CHANNELS)} t-major',
        fused_fc0.bound_ms(n, [7 * c for c in MLP_CHANNELS], coarse_bytes=0,
                           q_cols=3),
        after=lambda: dict(staging=list(fused_fc0.mlp_staging)))
    row['cases'] = mlp_cases(fused_fc0, args, n)
    if row['staging'] != ['taps', 'rows', 'rows', 'rows']:
        fail(f'fused_fc0_mlp staged the production stacks by '
             f'{row["staging"]}, not by its vector paths')
    return row


def _offset(t, k=1):
    """t's values in a contiguous view k elements into a larger buffer."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    return buf[k:].view(t.shape).copy_(t)


def mlp_cases(fused_fc0, args, n):
    """K4's other staging paths on the production inputs: every stack one
    bf16 into its buffer (no 16-byte aligned base: every scale 'scalar'),
    and the first 64 x 150 + 37 queries (n % 8 != 0: the C = 1 scale
    'scalar'), each against its plain version; both stage the same tile as
    the production launch, so their outputs must be its rows bit for
    bit."""
    kernel, plain = fused_fc0.fused_fc0_mlp, fused_fc0.fused_fc0_mlp_plain
    y = kernel(*args)
    m = 64 * 150 + 37
    cases = []
    for label, a, rows in (
            (f'n={n} base +1 bf16', ([_offset(s) for s in args[0]],)
             + args[1:], n),
            (f'n={m}', ([s[:, :m].contiguous() for s in args[0]],
                        args[1][:m].contiguous(), args[2][:m].contiguous())
             + args[3:], m)):
        got, err, ok, _ = _head_check(kernel, plain, a)
        case = dict(case=label, staging=list(fused_fc0.mlp_staging),
                    max_abs_err=err, ok=ok,
                    same_as_production=bool(torch.equal(got, y[:rows])),
                    ms=time_ms(lambda: kernel(*a), 5, device=y.device))
        print('kernel fused_fc0_mlp case', json.dumps(case), flush=True)
        cases.append(case)
        del a, got
    if cases[0]['staging'] != ['scalar'] * 4 \
            or cases[1]['staging'] != ['scalar', 'rows', 'rows', 'rows']:
        fail(f'fused_fc0_mlp took staging paths {cases}')
    if not all(c['ok'] and c['same_as_production'] for c in cases):
        fail('fused_fc0_mlp disagrees with its plain version or with its '
             'production launch off the vector staging paths')
    return cases


TRAIN_STEPS = 3  # timed, after one warm step


def train_path(ex, batches, stencil3d, fused_fc0, want=None):
    """One warm step, then ``len(batches) - 1`` timed LISTExecutor.train
    steps; the launch counters are set to 0 after the warm step and
    checked after every step against ``want`` (``step_launches()``)."""
    want = want or step_launches()
    ex.train(batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    steps = []
    for i, b in enumerate(batches[1:]):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        _, losses = ex.train(b)
        after = launch_counts()
        rec = dict(step=i, step_s=ex.timings['step_s'],
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses={k: float(v) for k, v in losses.items()},
                   launches={k: after[k] - before[k] for k in after})
        print('train step', json.dumps(rec), flush=True)
        steps.append(rec)
        if not all(np.isfinite(v) for v in rec['losses'].values()):
            fail(f'train step {i}: a loss is not finite')
        if rec['launches'] != want:
            fail(f'train step {i}: launches {rec["launches"]}, expected '
                 f'{want}')
    total = launch_counts()
    print('train path launches', json.dumps(total), flush=True)
    return steps, total


NO_WAITS_GRIDS = (128, 256)  # the checked dense decodes' R
NO_WAITS_STEP = (8, 32768, 128)  # the checked step's batch, queries, R


def _no_waits(name, fn, inputs=0):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('error')`` and the
    upload probe -> (result, host seconds to the synchronized end); fails
    on a synchronizing call, or on more host arrays made tensors than the
    call's ``inputs`` (a train step's batch)."""
    from tools.torch_decode_probe import numpy_uploads, sync_sites
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with numpy_uploads() as uploads, sync_sites('error'):
            out = fn()
    except RuntimeError as e:
        if 'synchroniz' not in str(e):
            raise
        import traceback
        fail(f'{name} waited on the card after its warm call: '
             f'{traceback.format_exc(limit=-4)}')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(uploads) > inputs:
        fail(f'{name} made {len(uploads)} tensors of host arrays after its '
             f'warm call, {inputs} of them its inputs: {uploads[:8]}')
    return out, wall


def sync_phase(model, img, card_line):
    """After a warm call each, nothing in an encode, a 128^3 and a 256^3
    dense decode (``LISTExecutor._decode``, one card) or a stage-2 train
    step at the reference recipe (batch 8 x 32,768 queries, remat,
    ``--remat_save_samples 1``, 4 query chunks; a seeded random batch)
    synchronizes with the card, apart from the step's batch upload and
    closing synchronization, and nothing makes a tensor of a host array:
    the constants stay on the card (``list_tpu_torch/ops/consts.py``).
    Each checked call runs under ``torch.cuda.set_sync_debug_mode('error')``
    and the upload probe; any wait or upload fails the run.  Each checked
    decode launches what ``decode_launches`` says of its plan; the 256^3
    one (slabs of 8, K1) is held to the plain head (``use_pallas`` 0)
    within 1e-2 + 1e-2 |plain|; the chunked decoder (``LIST.decode_sdf``)
    over the first 4 of the 128^3 grid's chunks launches no kernel.  One
    ``no waits`` line."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.ops.grid import create_grid_points_from_bounds
    from list_tpu_torch.train import LISTExecutor
    from tools.torch_decode_probe import waits_allowed
    rec = dict(card=card_line)
    x = torch.as_tensor(img, device='cuda')
    model.eval()
    with torch.inference_mode():
        model.encode(x)
        enc, rec['encode_s'] = _no_waits('LIST.encode',
                                         lambda: model.encode(x))
        for R in NO_WAITS_GRIDS:
            ex = LISTExecutor(default_config(vox_res=R, sdf_scale=10.0),
                              model)
            plan = ex._dense_plan(1)
            ex._decode(enc, *plan)
            reset_launch_counts()
            grid, rec[f'decode_{R}_s'] = _no_waits(
                f'the {R}^3 decode', lambda: ex._decode(enc, *plan))
            rec[f'decode_{R}_launches'] = launch_counts()
            if grid.shape != (R,) * 3 or not bool(torch.isfinite(grid).all()):
                fail(f'the checked {R}^3 decode is not a finite grid')
            want = decode_launches(True, R, *plan)
            if rec[f'decode_{R}_launches'] != want:
                fail(f'the {R}^3 decode: launches '
                     f'{rec[f"decode_{R}_launches"]}, expected {want}')
            if R == 256:
                plain = ex._decode(enc, plan[0], 0)
                err = (grid - plain).abs()
                rec['decode_256_plain_head_err'] = float(err.max())
                if not bool((err <= 1e-2 + 1e-2 * plain.abs()).all()):
                    fail(f'the 256^3 decode (plan {plan}) is '
                         f'{float(err.max()):.3g} off the plain head')
                del plain, err
            else:
                pts = create_grid_points_from_bounds(ex.bb_min, ex.bb_max, R)
                pts = torch.as_tensor(pts[:4 * ex.test_pointnum][None],
                                      dtype=torch.float32, device='cuda')
                reset_launch_counts()
                vals = [model.decode_sdf(c, enc)
                        for c in pts.split(ex.test_pointnum, 1)]
                rec['chunked_launches'] = launch_counts()
                if rec['chunked_launches'] != decode_launches(True, R, None,
                                                              0):
                    fail('the chunked decoder launched '
                         f'{rec["chunked_launches"]}, expected none')
                if not all(bool(torch.isfinite(v).all()) for v in vals):
                    fail('the chunked decoder gave a value not finite')
                del pts, vals
            del ex, grid
        del enc
    torch.cuda.empty_cache()

    b, nq, R = NO_WAITS_STEP
    tcfg = default_config(vox_res=R, train_batch_size=b,
                          sample_point_density=nq, sdf_scale=10.0,
                          remat_save_samples=1)
    rng = np.random.RandomState(1)
    batch = {
        'rgb_image': rng.rand(b, 224, 224, 3).astype(np.float32),
        'points': rng.uniform(-0.5, 0.5, (b, nq, 3)).astype(np.float32),
        'values': (rng.randn(b, nq) * 0.05).astype(np.float32),
        'occ': (rng.rand(b, R, R, R) > 0.99).astype(np.float32),
    }
    torch.manual_seed(1)
    tex = LISTExecutor(tcfg, LIST.from_config(tcfg))
    tex.train(batch)
    tex._to_device = waits_allowed(tex._to_device)
    tex._sync = waits_allowed(tex._sync)
    (_, losses), rec['step_s'] = _no_waits(
        'the train step', lambda: tex.train(batch),
        inputs=len(tex._train_keys(batch)))
    rec['losses'] = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in rec['losses'].values()):
        fail(f'the checked train step\'s losses: {rec["losses"]}')
    del tex
    torch.cuda.empty_cache()
    print('no waits', json.dumps(rec), flush=True)
    return rec


def _rel(a, r) -> float:
    """||a - r|| / ||r|| (L2 over all elements)."""
    return float((a - r).norm()) / max(float(r.norm()), 1e-300)


def _step_run(ex, losses) -> dict:
    """One train step's losses, gradients, BatchNorm statistics and
    parameters, in f64 on the host."""
    m = ex.model
    f64 = lambda a: None if a is None else a.detach().double().cpu()  # noqa
    return dict(losses={k: f64(v) for k, v in losses.items()},
                grads={k: f64(p.grad) for k, p in m.named_parameters()},
                stats={k: f64(v) for k, v in m.state_dict().items()
                       if 'running' in k},
                params={k: f64(p) for k, p in m.named_parameters()})


def _reference_runs(cfg, model, batch, Executor) -> dict:
    """The step on the CPU plain path in f32 and in f64 (the exact
    reference), from ``model``'s weights."""
    runs = {}
    for name, dt in (('cpu', torch.float32), ('cpu64', torch.float64)):
        ex = Executor(cfg, copy.deepcopy(model).to(dt), device='cpu')
        runs[name] = _step_run(ex, ex.train(batch)[1])
        del ex
    return runs


def card_gradient_check(cfg, model, batch, Executor, device='cuda',
                        card=None, refs=None):
    """One ``Executor.train`` step (``LISTExecutor`` or
    ``CoarseNetExecutor``) on ``device`` (f32) against the same step on the
    CPU plain path in f32 and in f64 (the exact reference), from the same
    weights and batch.

    With e(x) = ||x - f64|| / ||f64||, every loss, parameter gradient and
    updated BatchNorm statistic must satisfy
        e(card) <= min(4 * e(cpu f32), 0.1) + floor,
    floor 1e-3 for the losses (one flipped sign of the 2,048 queries moves
    ignore_sdf_accuracy by 4.9e-4), 2e-3 for the gradients and 1e-4 for the
    statistics: the card is held to the CPU's own f32 accuracy, and never
    further than 10% of the reference from it.  A gradient that is zero by
    construction (max|f64| below 1e-9 of the largest gradient: a conv bias
    before a BatchNorm) must stay below 1e-4 of the largest gradient (the
    CPU's f32 rounding leaves up to 1.3e-5 there).  Every gradient of the
    f64 reference must be present and finite on the card, and non-zero
    where the CPU's is; a parameter without one there has none on the
    card either.  The
    card's updated parameters must equal the CPU's Adam applied to the
    card's own gradients from the same weights, within
    1e-6 * max|p| + 1e-3 * lr.

    The caller feeds seeded noise images: the synthetic renders' flat
    backgrounds leave channels with a near-zero batch variance, where the
    training BatchNorms amplify f32 rounding into O(1) of many gradients on
    any device, so no f32 gradient could be held to a tolerance there.

    ``card`` and ``refs`` take a card step (``_step_run``) and the CPU
    runs (``_reference_runs``) made elsewhere: the distributed phase holds
    its 2-rank step to the 1-process references this way."""
    if card is None:
        ex = Executor(cfg, copy.deepcopy(model), device=device)
        card = _step_run(ex, ex.train(batch)[1])
        del ex
    runs = dict(card=card,
                **(refs or _reference_runs(cfg, model, batch, Executor)))
    card, cpu, ref = (runs[n] for n in ('card', 'cpu', 'cpu64'))
    gmax = max(float(r.abs().max()) for r in ref['grads'].values()
               if r is not None)
    bad, ratio, vox, capped = [], {}, {}, 0
    for part, floor in (('losses', 1e-3), ('grads', 2e-3), ('stats', 1e-4)):
        for k, r in ref[part].items():
            c, g = cpu[part][k], card[part][k]
            if r is None:  # no gradient reaches it on the CPU
                if g is not None:
                    bad.append((k, 'a gradient on the card only'))
                continue
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
    adam = Executor(cfg, copy.deepcopy(model), device='cpu')
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


REMAT_LEVELS = (0, 1, 2)  # --remat_save_samples


def _level_steps(cfg, base, batches, level):
    """``len(batches)`` LISTExecutor.train steps (the first warm) of a copy
    of ``base`` under ``--remat_save_samples level``: each step's losses,
    step_s and peak memory, and the final run (_step_run)."""
    from list_tpu_torch.train import LISTExecutor
    model = copy.deepcopy(base)
    model.remat_save_samples = level
    ex = LISTExecutor(cfg, model)
    ex.init_optimizer()
    steps = []
    for b in batches:
        torch.cuda.reset_peak_memory_stats()
        _, losses = ex.train(b)
        steps.append(dict(step_s=ex.timings['step_s'],
                          peak_device_gb=torch.cuda.max_memory_allocated()
                          / 1e9,
                          losses={k: float(v) for k, v in losses.items()}))
    run = _step_run(ex, losses)
    del ex, model
    torch.cuda.empty_cache()
    return steps, run


def remat_levels_phase(args, cfg, batches, card_line):
    """The training cell (batch 8 x 32,768 queries at 128^3, --remat 1,
    --train_query_chunks 4) at --remat_save_samples 0, 1 and 2 from the
    same seeded weights and batches: 1 warm and 2 timed steps per level
    as the port runs by default (step_s, peak memory), then 2 steps per
    level with deterministic algorithms (3x slower, so one step fewer),
    where both steps' losses, the parameters after them and the BatchNorm
    statistics must agree with level 0's within
    tests/test_torch_train.py's remat tolerances (losses rtol 1e-9;
    parameters 1e-10 + 1e-6 * max|p|; statistics 1e-12)."""
    from list_tpu_torch.models import LIST
    torch.manual_seed(args.seed)
    base = LIST.from_config(cfg)
    levels = {}
    for level in REMAT_LEVELS:
        steps, _ = _level_steps(cfg, base, batches, level)
        levels[level] = dict(steps=steps)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for level in REMAT_LEVELS:
            levels[level]['deterministic_steps'], runs[level] = \
                _level_steps(cfg, base, batches[:2], level)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    ref, bad = levels[0]['deterministic_steps'], []
    for level in REMAT_LEVELS[1:]:
        got = levels[level]['deterministic_steps']
        for i, (a, b) in enumerate(zip(got, ref)):
            for k, v in b['losses'].items():
                if abs(a['losses'][k] - v) > 1e-9 * abs(v):
                    bad.append((level, i, k, a['losses'][k], v))
        same = True
        for part, tol in (('params', 1e-6), ('stats', 0.0)):
            for k, r in runs[0][part].items():
                err = float((runs[level][part][k] - r).abs().max())
                same = same and err == 0
                lim = (1e-10 + tol * float(r.abs().max()) if tol
                       else 1e-12)
                if err > lim:
                    bad.append((level, part, k, err, lim))
        levels[level]['bit_identical_to_level_0'] = same and not any(
            b[0] == level for b in bad)
    for level, rec in levels.items():
        print('remat level', json.dumps(dict(
            card=card_line, remat_save_samples=level,
            step_s=[st['step_s'] for st in rec['steps'][1:]],
            peak_device_gb=[st['peak_device_gb'] for st in rec['steps']],
            deterministic_step_s=[st['step_s'] for st in
                                  rec['deterministic_steps'][1:]],
            bit_identical_to_level_0=rec.get('bit_identical_to_level_0'),
            losses=rec['deterministic_steps'][-1]['losses'])), flush=True)
    if bad:
        fail(f'--remat_save_samples changes the step: {bad[:10]}')
    return levels


OVERFIT_STEPS = 400  # tools/torch_overfit_chip.py's default


def overfit_phase(args, stencil3d, fused_fc0, card_line):
    """tools/torch_overfit_chip.py at its 400 steps on the card (module
    docstring, phase 7): its gate, and every step's and the mesh's launch
    counts (read around each LISTExecutor.train and predict_grid call)."""
    import importlib.util
    from list_tpu_torch.train import LISTExecutor
    spec = importlib.util.spec_from_file_location(
        'torch_overfit_chip', os.path.join(HERE, 'tools',
                                           'torch_overfit_chip.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    per = {'train': [], 'predict_grid': []}
    real = {k: getattr(LISTExecutor, k) for k in per}

    def counted(kind):
        def call(self, *a, **kw):
            before = launch_counts()
            out = real[kind](self, *a, **kw)
            after = launch_counts()
            per[kind].append({k: after[k] - before[k] for k in after})
            return out
        return call

    for k in real:
        setattr(LISTExecutor, k, counted(k))
    reset_launch_counts()
    try:
        rec = tool.main('cuda', OVERFIT_STEPS, args.seed,
                        log=lambda line: print(f'overfit| {line}',
                                               flush=True))
    finally:
        for k, f in real.items():
            setattr(LISTExecutor, k, f)
    total = launch_counts()
    cfg = tool.overfit_config()
    step = step_launches(batch=cfg.train_batch_size, R=cfg.vox_res,
                         remat=bool(cfg.remat))
    mesh = decode_launches(encodes=(1,))
    line = dict(card=card_line, steps=rec['steps'],
                first_losses=rec['first_losses'],
                last_losses=rec['last_losses'],
                step_s_median=rec['step_s_median'], train_s=rec['train_s'],
                peak_device_gb=rec['peak_device_gb'],
                vertices=rec['vertices'], iou=rec['iou'],
                gates=rec['gates'], launches=total,
                launches_per_step=per['train'][0] if per['train'] else None,
                launches_per_mesh=per['predict_grid'])
    print('overfit', json.dumps(line), flush=True)
    if not rec['passed']:
        fail(f'the overfit gate failed: {rec["gates"]}')
    if len(per['train']) != OVERFIT_STEPS or any(
            c != step for c in per['train']):
        fail(f'overfit: {len(per["train"])} steps, launches '
             f'{[c for c in per["train"] if c != step][:3]} '
             f'against {step} a step')
    if per['predict_grid'] != [mesh]:
        fail(f'overfit: the mesh launched {per["predict_grid"]}, expected '
             f'{mesh}')
    want = {k: OVERFIT_STEPS * step[k] + mesh[k] for k in total}
    if total != want:
        fail(f'overfit: launches {total}, expected {want}')
    return dict(rec, launches=total)


SWEEP_SHAPES = 8  # the synthetic test split
SWEEP_CAT = 'synthetic'  # its category
SWEEP_DROPPED = (1, 2, 3, 5)  # cached meshes deleted before the 2nd sweep
# each sweep's device phase (s) and fresh meshes/s when predict_grid still
# synchronized and the fetch copied on the default stream (PERF.md §5; NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's
SWEEP_SYNCHRONIZED_FETCH = {
    '--use_pallas 1': dict(device_phase_s=13.47, fresh_meshes_per_s=0.594),
    '--use_pallas -1 --infer_batch 2': dict(device_phase_s=21.34,
                                            fresh_meshes_per_s=0.187)}


def sweep_run(cfg, label, stencil3d, fused_fc0, shapes=SWEEP_SHAPES,
              run=None):
    """One ``test_all`` sweep on the card (``run()``, returning the CSV
    path: ``test_all(cfg)`` by default): the whole wall (model build and
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
            first = out[0] if isinstance(out, list) else out
            # the call's CUDA events; their times are read after the sweep
            calls.append((len(imgs), getattr(first, 'spans', None)))
            if calls[-1][1] is None:
                fail(f'sweep {label}: a device call returned no events')
            return out
        return call

    for k in real:
        setattr(LISTExecutor, k, timed(k))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        csv_path = test_all(cfg) if run is None else run()
    finally:
        for k, f in real.items():
            setattr(LISTExecutor, k, f)
    t1 = time.perf_counter()
    wall = t1 - t0
    counts = launch_counts()
    if csv_path is None:
        fail(f'sweep {label}: no checkpoint loaded or no CSV written')
    with open(csv_path) as f:
        header, *rows = list(csv.reader(f))
    vals = np.asarray([r[2:] for r in rows], np.float64)
    calls = [dict(images=n, **spans.resolve()) for n, spans in calls]
    fresh = sum(c['images'] for c in calls)
    device_phase = t1 - starts[0] if starts else float('nan')
    later = [c['decode_s'] for c in calls[1:]]
    rec = dict(sweep=label, wall_s=wall, device_phase_s=device_phase,
               fresh_meshes=fresh,
               fresh_meshes_per_s=fresh / device_phase,
               synchronized_fetch=SWEEP_SYNCHRONIZED_FETCH.get(label),
               first_decode_s=calls[0]['decode_s'] if calls else None,
               later_decode_s=[min(later), max(later)] if later else None,
               device_calls=calls, launches=counts,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               csv=os.path.relpath(csv_path, HERE), columns=header[2:],
               mean_row=dict(zip(header[2:], vals[-1].tolist())))
    print('sweep', json.dumps(rec), flush=True)
    if len(rows) != shapes + 1 or rows[-1][1] != 'Mean':
        fail(f'sweep {label}: {len(rows)} CSV rows, expected {shapes} and '
             'the mean row')
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


def _sweep_checkpoint(args, base):
    """The sweep's checkpoint under ``base``'s output directory: seeded
    weights, fc_out's bias set so the first test image's grid has its
    median at zero -> (model, its executor on the card, that image, the
    checkpoint's path)."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    from list_tpu_torch.train.checkpoints import save_checkpoint
    cfg = default_config(**base)
    torch.manual_seed(args.seed)
    model = LIST.from_config(cfg)
    ex = LISTExecutor(cfg, model)
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
    return model, ex, img, ckpt


def sweep_phase(args, stencil3d, fused_fc0):
    """The test-split sweep at full width and 128^3 (module docstring,
    phase 5)."""
    from list_tpu_torch.config import default_config
    root = os.path.join(HERE, 'build', 'chip_smoke_sweep')
    shutil.rmtree(root, ignore_errors=True)
    base = dict(model='network.models.LIST',
                dataset='datasets.Datasets.Synthetic', vox_res=128,
                sdf_scale=10.0, eval_pred=True, output_dir=root + '/',
                exp_name='sweep')
    cfg = default_config(use_pallas=1, **base)
    model, ex, img, ckpt = _sweep_checkpoint(args, base)

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
    want = decode_launches(slab=64, head=1, meshes=SWEEP_SHAPES,
                           encodes=(1,) * SWEEP_SHAPES)
    if first['launches'] != want or first['fresh_meshes'] != SWEEP_SHAPES:
        fail(f'sweep --use_pallas 1: launches {first["launches"]} for '
             f'{first["fresh_meshes"]} fresh meshes, expected {want}')

    out = os.path.dirname(os.path.join(HERE, first['csv']))
    for i in SWEEP_DROPPED:
        os.remove(os.path.join(out, 'synthetic', str(i), '00_pred.obj'))
    cfg2 = default_config(infer_batch=2, **base)
    second = sweep_run(cfg2, '--use_pallas -1 --infer_batch 2', stencil3d,
                       fused_fc0)
    # one encode of each pair of test shapes with a dropped mesh
    groups = collections.Counter(i // 2 for i in SWEEP_DROPPED)
    want = decode_launches(meshes=len(SWEEP_DROPPED),
                           encodes=tuple(groups.values()))
    if second['launches'] != want \
            or second['fresh_meshes'] != len(SWEEP_DROPPED):
        fail(f'sweep --infer_batch 2: launches {second["launches"]} for '
             f'{second["fresh_meshes"]} fresh meshes, expected {want}')
    return dict(sweeps=[first, second], band=bands, checkpoint=ckpt)


# ---- the training driver (stage 1 -> split -> warm-started stage 2) ---------

COARSE_BATCH = 16  # the README's stage-1 recipe


def stage1_phase(args, stencil3d, fused_fc0):
    """The full-width CoarseNet (ResNet18 at 224^2, TreeGCN to 4,096
    points) at batch 16: 1 warm and 3 timed ``CoarseNetExecutor.train``
    steps on the synthetic shapes (each twice in a batch), step_s, peak
    memory and the Chamfer loss per step, no kernel launched; then one
    small step (batch 2, 64^2 noise images) held against the CPU in f32
    and f64 by ``card_gradient_check``."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset, collate
    from list_tpu_torch.models import CoarseNet
    from list_tpu_torch.train.executors import CoarseNetExecutor
    cfg = default_config(model='network.models.CoarseNet',
                         train_batch_size=COARSE_BATCH)
    t0 = time.perf_counter()
    ds = SyntheticSDFDataset(cfg, 'train')
    items = [{k: ds[i][k] for k in ('rgb_image', 'pc')}
             for i in range(len(ds))]
    batch = collate([items[i % len(items)] for i in range(COARSE_BATCH)])
    print(f'stage 1 data {time.perf_counter() - t0:.1f} s', flush=True)
    torch.manual_seed(args.seed + 2)
    ex = CoarseNetExecutor(cfg, CoarseNet.from_config(cfg))
    ex.train(batch)
    torch.cuda.synchronize()
    steps = []
    for i in range(TRAIN_STEPS):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        _, losses = ex.train(batch)
        rec = dict(step=i, batch=COARSE_BATCH, step_s=ex.timings['step_s'],
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                   chamfer_loss=float(losses['chamfer_loss']),
                   launches=launch_counts())
        print('stage 1 step', json.dumps(rec), flush=True)
        steps.append(rec)
        if not np.isfinite(rec['chamfer_loss']):
            fail(f'stage 1 step {i}: the Chamfer loss is not finite')
        if rec['launches'] != launches():
            fail(f'stage 1 step {i}: launches {rec["launches"]}, expected '
                 'none')
    del ex
    torch.cuda.empty_cache()

    scfg = default_config(train_batch_size=2)
    small = collate(items[:2])
    small['rgb_image'] = np.random.RandomState(args.seed + 6).rand(
        2, 64, 64, 3).astype(np.float32)
    torch.manual_seed(args.seed + 3)
    check = card_gradient_check(scfg, CoarseNet.from_config(scfg), small,
                                CoarseNetExecutor, 'cuda')
    if not check['ok']:
        fail(f'one CoarseNet step on the card disagrees with the CPU plain '
             f'path: {json.dumps(check["bad"])}')
    return dict(steps=steps, gradient_check=check)


def driver_run(cfg, label, Executor, stencil3d, fused_fc0, run=None,
               seen=None):
    """``trainer.train(cfg)`` (or ``run()``) on the card, with each
    optimizer step's and testlist shape's launch counts (read around the
    call), step_s and peak memory, and each epoch's and testlist eval's
    wall recorded; ``seen`` (a list) gets the executor of every step."""
    from list_tpu_torch.train import trainer
    events = []
    real = dict(train=Executor.train, test=Executor.test,
                epoch=trainer.train_one_epoch, testlist=trainer.run_testlist)

    def counted(kind):
        def call(self, batch, *a, **kw):
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real[kind](self, batch, *a, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            rec = dict(kind=kind, wall_s=time.perf_counter() - t0,
                       peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches={k: after[k] - before[k] for k in after})
            if kind == 'train':
                rec['step_s'] = self.timings['step_s']
                rec['losses'] = {k: float(v) for k, v in out[1].items()}
                if seen is not None:
                    seen.append(self)
            elif isinstance(out[0], list):  # LIST: [mesh, grid], scores
                mesh, grid = out[0]
                rec.update(vertices=len(mesh.vertices), scores=out[1],
                           grid_min=float(grid.min()),
                           grid_median=float(np.median(grid)),
                           grid_max=float(grid.max()))
            events.append(rec)
            return out
        return call

    def walled(kind):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real[kind](*a, **kw)
            rec = dict(kind=kind, wall_s=time.perf_counter() - t0)
            rec['mean_loss' if kind == 'epoch' else 'scores'] = out
            events.append(rec)
            return out
        return call

    Executor.train, Executor.test = counted('train'), counted('test')
    trainer.train_one_epoch = walled('epoch')
    trainer.run_testlist = walled('testlist')
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.train(cfg) if run is None else run()
    finally:
        Executor.train, Executor.test = real['train'], real['test']
        trainer.train_one_epoch = real['epoch']
        trainer.run_testlist = real['testlist']
    rec = dict(driver=label, wall_s=time.perf_counter() - t0,
               launches=launch_counts(), events=events)
    print('driver', json.dumps(rec, default=float), flush=True)
    return rec


def _check_driver(rec, step, test):
    """Every step and testlist shape launched exactly its kernels (``step``
    and ``test``), nothing else launched any, and every loss is finite."""
    steps = [e for e in rec['events'] if e['kind'] == 'train']
    tests = [e for e in rec['events'] if e['kind'] == 'test']
    label = rec['driver']
    if not steps or not tests:
        fail(f'{label}: {len(steps)} steps and {len(tests)} testlist shapes')
    for e in steps + tests:
        want = step if e['kind'] == 'train' else test
        if e['launches'] != want:
            fail(f'{label}: a {e["kind"]} call launched {e["launches"]}, '
                 f'expected {want}')
    total = {k: len(steps) * step[k] + len(tests) * test[k] for k in step}
    if rec['launches'] != total:
        fail(f'{label}: launches {rec["launches"]}, expected {total}')
    if not all(np.isfinite(v) for e in steps for v in e['losses'].values()):
        fail(f'{label}: a loss is not finite')


def driver_phase(args, stencil3d, fused_fc0):
    """The README's two-stage recipe through ``trainer.train`` on the
    synthetic dataset (8 shapes, 224^2 renders), with a testlist of two of
    them: CoarseNet at batch 8 for 1 epoch, ``split_coarse`` of its
    best-train checkpoint, then the full-width LIST warm-started from the
    split (``im_encoder`` and ``point_decoder`` frozen) at vox_res 128,
    batch 8 x 32,768 queries, remat, 4 query chunks, 1 epoch, its testlist
    eval at 128^3 with ``--eval_pred``.  Checks the launch counts, the
    checkpoint files (``best_model_test`` exactly when the eval scored: from
    random weights one epoch leaves every grid cell of one sign, so its
    meshes are empty), the frozen submodules bit-identical to the split and
    ``im_encoder2`` moved."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import checkpoints as ckpt
    from list_tpu_torch.train.executors import (CoarseNetExecutor,
                                                LISTExecutor)
    from list_tpu_torch.train.split_coarse import split_coarse_checkpoint
    root = os.path.join(HERE, 'build', 'chip_smoke_train')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    testlist = os.path.join(root, 'testlist.lst')
    with open(testlist, 'w') as f:
        f.write('synthetic 0 00\nsynthetic 1 00\n')
    base = dict(dataset='datasets.Datasets.Synthetic', catlist=['synthetic'],
                testlist_file=testlist, output_dir=root + '/', epochs=1,
                save_every_epoch=1, test_every_epoch=1, train_batch_size=8,
                seed=args.seed)
    c1 = default_config(model='network.models.CoarseNet',
                        exp_name='coarse_prediciton', **base)
    torch.manual_seed(args.seed + 4)
    first = driver_run(c1, 'stage 1 (CoarseNet)', CoarseNetExecutor,
                       stencil3d, fused_fc0)
    _check_driver(first, launches(), launches())
    t0 = time.perf_counter()
    split_coarse_checkpoint(os.path.join(c1.checkpoint_dir,
                                         'best_model_train.ckpt'),
                            c1.checkpoint_dir)
    split_s = time.perf_counter() - t0

    c2 = default_config(model='network.models.LIST', exp_name='list',
                        warm_start=True, vox_res=128,
                        sample_point_density=32768, remat=1,
                        train_query_chunks=4, sdf_scale=10.0, eval_pred=True,
                        **base)
    torch.manual_seed(args.seed + 5)
    second = driver_run(c2, 'stage 2 (LIST, warm start)', LISTExecutor,
                        stencil3d, fused_fc0)
    _check_driver(second, step_launches(), decode_launches(encodes=(1,)))

    files = {d: sorted(f for f in os.listdir(d) if f.endswith('.ckpt'))
             for d in (c1.checkpoint_dir, c2.checkpoint_dir)}
    print('driver checkpoints', json.dumps(
        {os.path.relpath(d, HERE): v for d, v in files.items()}), flush=True)
    # best_model_test follows the driver's rule: written when the testlist
    # eval scored (IoU or Chamfer), which an empty mesh does not
    scored = any(e['kind'] == 'testlist' and ('iou' in e['scores'] or
                                              'chamfer_l2' in e['scores'])
                 for e in second['events'])
    want = {c1.checkpoint_dir: {'model_1.ckpt', 'best_model_train.ckpt',
                                'best_IME_test.ckpt', 'best_PD_test.ckpt'},
            c2.checkpoint_dir: {'model_1.ckpt', 'best_model_train.ckpt'}
            | ({'best_model_test.ckpt'} if scored else set())}
    for d, names in want.items():
        if set(files[d]) != names:
            fail(f'driver checkpoints in {d}: {files[d]}, expected '
                 f'{sorted(names)}')
    trained = LIST.from_config(c2)
    ckpt.load_checkpoint(os.path.join(c2.checkpoint_dir, 'model_1.ckpt'),
                         trained)
    split = LIST.from_config(c2)
    for name, fname in (('im_encoder', 'best_IME_test.ckpt'),
                        ('im_encoder2', 'best_IME_test.ckpt'),
                        ('point_decoder', 'best_PD_test.ckpt')):
        ckpt.load_submodule(os.path.join(c1.checkpoint_dir, fname), split,
                            name)
    same = {name: all(torch.equal(a, b) for a, b in zip(
        getattr(trained, name).parameters(),
        getattr(split, name).parameters()))
        for name in ('im_encoder', 'point_decoder', 'im_encoder2')}
    print('warm start: parameters bit-identical to the split',
          json.dumps(same), flush=True)
    if not (same['im_encoder'] and same['point_decoder']):
        fail('a frozen submodule moved in the warm-started epoch')
    if same['im_encoder2']:
        fail('im_encoder2 did not move in the warm-started epoch')
    return dict(stage1=first, split_s=split_s, stage2=second,
                checkpoints=files, frozen_identical=same)


# ---- the Pix3D phase: raw meshes -> preprocessing -> FPS -> train -> sweep --

PIX3D_SHAPES = 8  # one image a shape, all in the train split
PIX3D_TEST = 4  # the test split: the first four images
PIX3D_POINTS = 50000  # preprocessing's published --num_points
PIX3D_SIGMAS = (0.003, 0.01, 0.07)  # and --sigma
FPS_K = 5000  # farthest_pointcloud's published --k


def _covering_radius(pts, idx, chunk=8192) -> float:
    """max over the points of the distance to the nearest chosen point
    (f64, on the points' device)."""
    p = pts.double()
    c = p[idx]
    return max(float(torch.cdist(p[i:i + chunk], c).min(1).values.max())
               for i in range(0, len(p), chunk))


def fps_check(h5_dir, card_line):
    """The port's FPS at k = 5,000 on every shape's 50,000 grid points: on
    the card (synchronized wall a shape) against the same function on the
    CPU (identical indices expected; fails unless the covering radii agree
    to 1e-6 relative), then ``run_fps`` over the tree on the card, whose
    files must hold the card's points."""
    import glob

    from list_tpu_torch.data.preprocess import run_fps
    from list_tpu_torch.ops.fps import farthest_point_sampling
    from list_tpu_torch.utils import h5
    files = sorted(glob.glob(os.path.join(h5_dir, '*', '*',
                                          'sampled_points.h5')))
    raw, pts, card, card_s, refs, cpu_s = [], [], [], [], [], []
    for fn in files:
        with h5.File(fn, 'r') as f:
            raw.append(f['grid_points'][:])
        pts.append(torch.as_tensor(raw[-1], dtype=torch.float32))
        card_pts = pts[-1].cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.append(farthest_point_sampling(card_pts, FPS_K))
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        refs.append(farthest_point_sampling(pts[-1], FPS_K))
        cpu_s.append(time.perf_counter() - t0)
    shapes = []
    for fn, r, p, idx, ref, t, tc in zip(files, raw, pts, card, refs, card_s,
                                         cpu_s):
        got = idx.cpu()
        diff = (got != ref).nonzero()
        p = p.cuda()
        r_card = _covering_radius(p, idx)
        r_cpu = _covering_radius(p, ref.cuda())
        shapes.append(dict(
            shape=os.path.basename(os.path.dirname(fn)), n=len(p), card_s=t,
            cpu_s=tc,
            leading_equal=int(diff[0]) if len(diff) else FPS_K,
            identical=not len(diff), covering_radius=r_card,
            radius_rel_diff=abs(r_card - r_cpu) / r_cpu,
            points=r[got.numpy()]))
    for s in shapes:
        print('fps shape', json.dumps({k: v for k, v in s.items()
                                        if k != 'points'}), flush=True)
    bad = [s['shape'] for s in shapes if s['radius_rel_diff'] > 1e-6]
    if bad:
        fail(f'FPS on the card: covering radius off the CPU\'s by more than '
             f'1e-6 relative for {bad}')
    t0 = time.perf_counter()
    done = run_fps(h5_dir, FPS_K)
    run_s = time.perf_counter() - t0
    if done != len(files):
        fail(f'run_fps processed {done} of {len(files)} shapes')
    for fn, s in zip(files, shapes):
        with h5.File(os.path.join(os.path.dirname(fn),
                                  'farthest_pointclouds.h5'), 'r') as f:
            if not np.array_equal(f[f'points_{FPS_K}'][:], s.pop('points')):
                fail(f'run_fps wrote other points than the card\'s FPS for '
                     f'{s["shape"]}')
    rec = dict(card=card_line, k=FPS_K, shapes=len(shapes),
               card_s_per_shape=card_s, median_card_s=float(np.median(card_s)),
               cpu_s_per_shape=cpu_s, run_fps_s_per_shape=run_s / len(shapes),
               identical=sum(s['identical'] for s in shapes),
               min_leading_equal=min(s['leading_equal'] for s in shapes),
               max_radius_rel_diff=max(s['radius_rel_diff'] for s in shapes))
    print('fps', json.dumps(rec), flush=True)
    return dict(rec, per_shape=shapes)


def _stage(rec):
    """One driver run's wall, optimizer steps' step_s and peaks."""
    steps = [e for e in rec['events'] if e['kind'] == 'train']
    return dict(wall_s=rec['wall_s'], step_s=[e['step_s'] for e in steps],
                peak_device_gb=[e['peak_device_gb'] for e in steps])


def pix3d_phase(args, stencil3d, fused_fc0, card_line):
    """The Pix3D path from raw meshes (module docstring, phase 8)."""
    import glob

    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import Pix3D, generate_synthetic_pix3d
    from list_tpu_torch.data.preprocess import run
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import checkpoints as ckpt
    from list_tpu_torch.train.executors import (CoarseNetExecutor,
                                                LISTExecutor)
    from list_tpu_torch.train.split_coarse import split_coarse_checkpoint
    root = os.path.join(HERE, 'build', 'chip_smoke_pix3d')
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    inputs = generate_synthetic_pix3d(root, n_shapes=PIX3D_SHAPES,
                                      n_test=PIX3D_TEST, seed=args.seed + 7)
    tree_s = time.perf_counter() - t0
    data = os.path.join(root, 'data')

    # preprocessing at the published settings
    pre_s = []
    for path in inputs:
        t0 = time.perf_counter()
        run(path, data, PIX3D_SIGMAS, PIX3D_POINTS)
        pre_s.append(time.perf_counter() - t0)
    made = sorted(glob.glob(os.path.join(data, 'sampled_points', '*', '*',
                                         'sampled_points.h5')))
    print('pix3d preprocessing', json.dumps(dict(
        shapes=len(made), num_points=PIX3D_POINTS, sigmas=PIX3D_SIGMAS,
        s_per_mesh=pre_s, tree_s=tree_s)), flush=True)
    if len(made) != PIX3D_SHAPES:
        fail(f'preprocessing wrote {len(made)} of {PIX3D_SHAPES} shapes')
    fps = fps_check(os.path.join(data, 'sampled_points'), card_line)

    # the two-stage recipe on Pix3D, with a testlist of two images
    testlist = os.path.join(root, 'testlist.lst')
    with open(testlist, 'w') as f:
        f.write('chair model000.model 0000\nchair model001.model 0001\n')
    base = dict(dataset='datasets.Datasets.Pix3D', data_dir=root + '/',
                catlist=['chair'], testlist_file=testlist,
                output_dir=os.path.join(root, 'results') + '/', epochs=1,
                save_every_epoch=1, test_every_epoch=1, train_batch_size=8,
                seed=args.seed)
    c1 = default_config(model='network.models.CoarseNet',
                        exp_name='coarse_prediciton_Pix3D', **base)
    if len(Pix3D(c1, 'train')) != PIX3D_SHAPES:
        fail('the Pix3D reader did not find every preprocessed shape')
    torch.manual_seed(args.seed + 8)
    first = driver_run(c1, 'pix3d stage 1 (CoarseNet)', CoarseNetExecutor,
                       stencil3d, fused_fc0)
    _check_driver(first, launches(), launches())
    t0 = time.perf_counter()
    split_coarse_checkpoint(os.path.join(c1.checkpoint_dir,
                                         'best_model_train.ckpt'),
                            c1.checkpoint_dir)
    split_s = time.perf_counter() - t0
    c2 = default_config(model='network.models.LIST', exp_name='list_Pix3D',
                        warm_start=True, vox_res=128,
                        sample_point_density=32768, remat=1,
                        train_query_chunks=4, sdf_scale=10.0, eval_pred=True,
                        **base)
    torch.manual_seed(args.seed + 9)
    second = driver_run(c2, 'pix3d stage 2 (LIST, warm start)', LISTExecutor,
                        stencil3d, fused_fc0)
    _check_driver(second, step_launches(), decode_launches(encodes=(1,)))
    files = {d: sorted(f for f in os.listdir(d) if f.endswith('.ckpt'))
             for d in (c1.checkpoint_dir, c2.checkpoint_dir)}
    scored = any(e['kind'] == 'testlist' and ('iou' in e['scores'] or
                                              'chamfer_l2' in e['scores'])
                 for e in second['events'])
    want = {c1.checkpoint_dir: {'model_1.ckpt', 'best_model_train.ckpt',
                                'best_IME_test.ckpt', 'best_PD_test.ckpt'},
            c2.checkpoint_dir: {'model_1.ckpt', 'best_model_train.ckpt'}
            | ({'best_model_test.ckpt'} if scored else set())}
    for d, names in want.items():
        if set(files[d]) != names:
            fail(f'pix3d checkpoints in {d}: {files[d]}, expected '
                 f'{sorted(names)}')
    trained = LIST.from_config(c2)
    ckpt.load_checkpoint(os.path.join(c2.checkpoint_dir, 'model_1.ckpt'),
                         trained)
    split = LIST.from_config(c2)
    for name, fname in (('im_encoder', 'best_IME_test.ckpt'),
                        ('point_decoder', 'best_PD_test.ckpt')):
        ckpt.load_submodule(os.path.join(c1.checkpoint_dir, fname), split,
                            name)
    same = {name: all(torch.equal(a, b) for a, b in zip(
        getattr(trained, name).parameters(),
        getattr(split, name).parameters()))
        for name in ('im_encoder', 'point_decoder')}
    if not all(same.values()):
        fail(f'pix3d: a frozen submodule moved in the warm-started epoch '
             f'({same})')

    # the sweep of the test split from stage 2's weights, fc_out's bias
    # centred on the first test image's grid (as the sweep phase does) so
    # every image has a surface to score; in a checkpoint of its own
    c3 = default_config(model='network.models.LIST', dataset=base['dataset'],
                        data_dir=base['data_dir'], catlist=['chair'],
                        output_dir=base['output_dir'],
                        exp_name='list_Pix3D_sweep', vox_res=128,
                        sdf_scale=10.0, eval_pred=True, seed=args.seed)
    test = Pix3D(c3, 'test')
    info = test.datalist[0]
    img = test.get_testdata(info['cat_id'], info['shape_id'],
                            info['img_id'].split('.')[0])['rgb_image']
    shift = float(np.median(LISTExecutor(c3, trained).predict_grid(
        img, fetch_mode='grid'))) * c3.sdf_scale
    with torch.no_grad():
        trained.sdf_decoder.fc_out.bias -= shift
    ckpt.save_checkpoint(0, trained, 0.5, os.path.join(c3.checkpoint_dir,
                                                       c3.test_checkpoint))
    del trained, split
    torch.cuda.empty_cache()
    sweep = sweep_run(c3, 'pix3d', stencil3d, fused_fc0, shapes=PIX3D_TEST)
    want = decode_launches(meshes=PIX3D_TEST, encodes=(1,) * PIX3D_TEST)
    if sweep['launches'] != want or sweep['fresh_meshes'] != PIX3D_TEST:
        fail(f'pix3d sweep: launches {sweep["launches"]} for '
             f'{sweep["fresh_meshes"]} fresh images, expected {want}')
    with open(os.path.join(HERE, sweep['csv'])) as f:
        ids = [r[1] for r in csv.reader(f)][1:]
    expect = [f'{d["shape_id"]}_{d["img_id"].split(".")[0]}'
              for d in test.datalist] + ['Mean']
    if ids != expect:
        fail(f'pix3d sweep rows {ids}, expected {expect}')

    rec = dict(card=card_line, shapes=PIX3D_SHAPES,
               preprocess_s_per_mesh=pre_s,
               fps_card_s_per_shape=fps['card_s_per_shape'],
               fps_identical_shapes=fps['identical'],
               fps_min_leading_equal=fps['min_leading_equal'],
               fps_max_radius_rel_diff=fps['max_radius_rel_diff'],
               fps_cpu_s_per_shape=fps['cpu_s_per_shape'],
               run_fps_s_per_shape=fps['run_fps_s_per_shape'],
               stage1=_stage(first), split_s=split_s, stage2=_stage(second),
               stage2_launches=second['launches'],
               sweep_wall_s=sweep['wall_s'],
               sweep_device_phase_s=sweep['device_phase_s'],
               sweep_fresh_meshes_per_s=sweep['fresh_meshes_per_s'],
               sweep_peak_device_gb=sweep['peak_device_gb'],
               wall_s=time.perf_counter() - t_phase)
    print('pix3d', json.dumps(rec), flush=True)
    return dict(rec, fps=fps, stage1_run=first, stage2_run=second,
                checkpoints=files, frozen_identical=same, sweep=sweep,
                fc_out_shift=-shift)


# ---- the distributed phase ----------------------------------------------------

DIST_WORLD = 2  # gloo ranks on the one card (NCCL refuses two on one GPU)
DIST_STEPS = 2  # timed 2-rank train steps, after one warm step
DIST_SHAPES = SWEEP_SHAPES // DIST_WORLD  # each rank's strided test shapes
SPLIT = ('cuda:0', 'cuda:0')  # the split decode's devices on one card


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _small_input(seed):
    """The small step's config, seeded full-width LIST at vox_res 32 and
    global batch of 4 x 1,024 queries with seeded noise images (see
    card_gradient_check) and a fixed camera: the batch's ``transmat`` is
    the model's own eval-mode prediction.

    Both choices keep every f32 gradient well-conditioned, so that an f32
    step can be held to another at all.  With the spatial transformer in
    the step, every gradient upstream of its batch-4 BatchNorm1d and
    ``trans_mat`` is rounding noise on any device (one CPU step at two
    thread counts disagrees by more than its own size there); the fixed
    camera leaves those parameters without a gradient, and their
    BatchNorms still run forward.  The biases of the voxel encoder's first
    layers feed a ReLU and then a BatchNorm, which removes a constant
    shift, so their gradients are near-total cancellations whose size
    depends on the data: with the model and images seeded ``seed + 7`` and
    ``seed + 8`` (``--seed 0``), ``bn_0.bias``'s gradient came out at a
    forty-thousandth of the largest one, and its f32 value moved by the
    check's 10% cap between two CPU runs that differ only in their thread
    count; the offsets below leave every gradient's f32 value steady
    there."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset, collate
    from list_tpu_torch.models import LIST
    cfg = default_config(vox_res=32, train_batch_size=4,
                         sample_point_density=1024, sdf_scale=10.0)
    ds = SyntheticSDFDataset(cfg, 'train', n_shapes=4)
    batch = collate([ds[i] for i in range(4)])
    batch['rgb_image'] = np.random.RandomState(seed + 9).rand(
        *batch['rgb_image'].shape).astype(np.float32)
    torch.manual_seed(seed + 8)
    model = LIST.from_config(cfg)
    with torch.no_grad():
        batch['transmat'] = model.eval().encode(torch.as_tensor(
            batch['rgb_image']))['trans_mat'].numpy()
    return cfg, model, batch


def _digests(ex) -> dict:
    """SHA-256 of the parameters, of the BatchNorm statistics and of the
    Adam moments, each over its tensors' bytes in name order."""
    import hashlib
    names = {id(p): k for k, p in ex.model.named_parameters()}
    groups = dict(
        params=sorted(ex.model.named_parameters()),
        batch_stats=sorted((k, v) for k, v in ex.model.state_dict().items()
                           if 'running' in k),
        adam=sorted((f'{names[id(p)]}.{m}', st[m])
                    for p, st in ex.optimizer.state.items()
                    for m in ('exp_avg', 'exp_avg_sq')))
    out = {}
    for g, items in groups.items():
        h = hashlib.sha256()
        for k, t in items:
            h.update(k.encode())
            h.update(t.detach().cpu().numpy().tobytes())
        out[g] = h.hexdigest()
    return out


def _sweep_flags(root, name):
    return dict(model='network.models.LIST',
                dataset='datasets.Datasets.Synthetic', vox_res=128,
                sdf_scale=10.0, eval_pred=True, exp_name='sweep',
                output_dir=os.path.join(root, name) + '/')


def dist_rank(args, stencil3d, fused_fc0):
    """One gloo rank of the distributed phase on ``cuda:0`` (run by
    ``dist_phase`` as ``chip_smoke.py --dist_rank R``): the full-width
    train steps at this rank's half of the global batch, the small step
    (rank 0 keeps its result), the sharded sweep; writes its record to
    ``<dist_dir>/rank<R>.json``."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset, collate
    from list_tpu_torch.models import LIST
    from list_tpu_torch.parallel import multihost
    from list_tpu_torch.train import LISTExecutor
    rank = multihost.initialize(f'127.0.0.1:{args.dist_port}', DIST_WORLD,
                                args.dist_rank, backend='gloo',
                                device='cuda:0')
    rec = dict(rank=rank, process_info=multihost.process_info())
    tcfg = default_config(vox_res=128, train_batch_size=8,
                          sample_point_density=32768, sdf_scale=10.0)
    ds = SyntheticSDFDataset(tcfg, 'train', n_shapes=8)
    batch = collate([ds[i] for i in range(8)])  # the global batch
    torch.manual_seed(args.seed)
    ex = LISTExecutor(tcfg, LIST.from_config(tcfg))
    ex.init_optimizer()
    rec['train_steps'], _ = train_path(
        ex, [batch] * (DIST_STEPS + 1), stencil3d, fused_fc0,
        step_launches(batch=tcfg.train_batch_size // DIST_WORLD,
                      group=True))
    rec['digests'] = _digests(ex)
    del ex, batch, ds
    torch.cuda.empty_cache()

    gcfg, model, gbatch = _small_input(args.seed)
    ex = LISTExecutor(gcfg, model)
    run = _step_run(ex, ex.train(gbatch)[1])
    rec['small_digests'] = _digests(ex)
    if rank == 0:
        torch.save(run, os.path.join(args.dist_dir, 'small_rank0.pt'))
    del ex, model, run
    torch.cuda.empty_cache()

    cfg = default_config(multihost=1, **_sweep_flags(args.dist_dir,
                                                     'sweep_ranks'))
    rec['sweep'] = sweep_run(cfg, f'rank {rank} of {DIST_WORLD}', stencil3d,
                             fused_fc0, shapes=DIST_SHAPES)
    want = decode_launches(meshes=DIST_SHAPES, encodes=(1,) * DIST_SHAPES)
    if rec['sweep']['launches'] != want:
        fail(f'rank {rank} sweep: launches {rec["sweep"]["launches"]}, '
             f'expected {want}')
    multihost.sync_global_devices('done')
    multihost.shutdown()
    with open(os.path.join(args.dist_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(rec, f, default=float)


def nccl_rank(args):
    """The small step twice with no process group and once in a 1-rank
    NCCL group (``chip_smoke.py --nccl_rank``), then once under
    ``--checkify`` and once more there with a NaN in the image,
    deterministic algorithms on; writes to ``<dist_dir>/nccl.json``
    whether each pair of clean steps is bit-identical, the NaN step's
    FloatingPointError and whether the executor's parameters, BatchNorm
    statistics, Adam moments and step survived it unchanged."""
    from list_tpu_torch.parallel import multihost
    from list_tpu_torch.train import LISTExecutor
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg, model, batch = _small_input(args.seed)
    runs = []
    for grouped in (False, False, True):
        if grouped:
            multihost.initialize(f'127.0.0.1:{args.dist_port}', 1, 0)
        ex = LISTExecutor(cfg, copy.deepcopy(model))
        runs.append(_step_run(ex, ex.train(batch)[1]))
        del ex
    backend = torch.distributed.get_backend()
    multihost.shutdown()

    def same(a, b):
        for part in a:
            for k, x in a[part].items():
                y = b[part][k]
                if (x is None) != (y is None) or (
                        x is not None and not torch.equal(x, y)):
                    return False
        return True

    # --checkify: the clean step as without the flag; then a NaN in the
    # image raises and leaves the executor as it was
    ccfg = copy.copy(cfg)
    ccfg.checkify = True
    ex = LISTExecutor(ccfg, copy.deepcopy(model))
    checked = _step_run(ex, ex.train(batch)[1])
    kept = dict(_digests(ex), step=ex.step)
    bad = dict(batch, rgb_image=batch['rgb_image'].copy())
    bad['rgb_image'][1, 100, 120, 0] = np.nan
    try:
        ex.train(bad)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    with open(os.path.join(args.dist_dir, 'nccl.json'), 'w') as f:
        json.dump(dict(backend=backend, repeat_identical=same(runs[0],
                                                              runs[1]),
                       nccl_identical=same(runs[0], runs[2]),
                       checkify_identical=same(runs[0], checked),
                       checkify_raised=raised,
                       checkify_state_kept=dict(_digests(ex), step=ex.step)
                       == kept), f)


def _spawn(args, flags, log):
    cmd = [sys.executable, os.path.abspath(__file__), '--seed',
           str(args.seed), '--dist_dir', args.dist_dir, *flags]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=':4096:8')
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def _join(procs, logs, label, timeout=240):
    """Wait for ``procs``, print their output, fail unless each exited 0;
    all are killed at the timeout or as soon as one fails (the others
    would wait in a collective)."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(p.poll() for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.2)
    codes = [p.wait() for p in procs]
    for path in logs:
        with open(path) as f:
            for line in f:
                print(f'{label} {os.path.basename(path)[:-4]}| {line}',
                      end='', flush=True)
    if any(codes):
        fail(f'{label}: exit codes {codes}')


def split_decode_check(cfg, model, img, fused_fc0, stencil3d, card_line):
    """``predict_grid`` with the slab range split over ``SPLIT`` against
    the unsplit grid of the same image: 2 K1 launches (each timed with
    CUDA events, n = R^3 / 2), bit for bit or within test_torch_slice.py's
    atol 5e-4 / rtol 2e-2; and ``dense_grid_sdf`` at one slab size over two
    row ranges against the whole grid, bit for bit."""
    from list_tpu_torch.ops import dense_grid
    from list_tpu_torch.train import LISTExecutor
    grid = dict(fetch_dtype='float32', fetch_mode='grid')
    whole = LISTExecutor(cfg, model)
    ref = whole.predict_grid(img, **grid)
    split = LISTExecutor(cfg, model, decode_devices=SPLIT)
    real, times = dense_grid.fused_stack_head, []

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = real(*a, **kw)
        e.record()
        times.append((s, e))
        return out

    dense_grid.fused_stack_head = timed
    reset_launch_counts()
    try:
        got = split.predict_grid(img, **grid)
    finally:
        dense_grid.fused_stack_head = real
    counts = launch_counts()
    torch.cuda.synchronize()
    err = float(np.abs(got - ref).max())
    tol = 5e-4 + 2e-2 * float(np.abs(ref).max())
    R = cfg.vox_res
    Ks = (85, 17, 17, 160, 32, 32, 320, 64, 64)
    with torch.inference_mode():
        enc = model.encode(torch.as_tensor(img, device='cuda'))
        args = (model.sdf_decoder, enc['vox_feat'], enc['feat_l2'],
                enc['trans_mat'], R)
        a = dense_grid.dense_grid_sdf(*args, slab=R // 2)
        b = torch.cat([dense_grid.dense_grid_sdf(*args, slab=R // 2,
                                                 x_range=r)
                       for r in ((0, R // 2), (R // 2, R))])
        same_slab = bool(torch.equal(a, b))
    bound, bound_by = fused_fc0.bound_ms(R ** 3 // len(SPLIT), Ks,
                                         coarse_bytes=2, q_cols=3)
    rec = dict(card=card_line, devices=list(SPLIT),
               plan=split._dense_plan(len(SPLIT)), launches=counts,
               k1_ms=[s.elapsed_time(e) for s, e in times],
               k1_n=R ** 3 // len(SPLIT), k1_bound_ms=bound,
               k1_bound_by=bound_by,
               decode_s=split.timings['decode_s'],
               unsplit_decode_s=whole.timings['decode_s'],
               bitwise=bool(np.array_equal(got, ref)), max_abs_err=err,
               tol=tol, same_slab_ranges_bitwise=same_slab)
    print('split decode', json.dumps(rec), flush=True)
    want = decode_launches(slab=R // len(SPLIT), encodes=(1,),
                           cards=len(SPLIT))
    if counts != want:
        fail(f'split decode: launches {counts}, expected {want}')
    if not (np.isfinite(got).all() and err <= tol and same_slab):
        fail('the split decode disagrees with the unsplit grid')
    return rec


def _offline_eval(gen_dir, mesh_dir, card_line):
    """evaluation/evaluate_torch.py (10,000 sample points a mesh, a tenth
    of its default, for the script's time) and evaluate_gather_torch.py
    over the sharded sweep's meshes: one pickle per shape, the gathered CSV
    with a row per shape and the mean row, finite metrics."""
    t0 = time.perf_counter()
    for script, flags in (('evaluate_torch.py', ['--gen_dir', gen_dir,
                                                  '--mesh_dir', mesh_dir,
                                                  '--n_points', '10000']),
                          ('evaluate_gather_torch.py',
                           ['--eval_dir', os.path.join(gen_dir, 'eval')])):
        r = subprocess.run([sys.executable,
                            os.path.join(HERE, 'evaluation', script),
                            *flags], cwd=HERE, capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            fail(f'{script}: exit {r.returncode}\n{r.stdout}{r.stderr}')
    with open(os.path.join(gen_dir, 'eval', 'gathered.csv')) as f:
        header, *rows = list(csv.reader(f))
    vals = np.asarray([r[2:] for r in rows], np.float64)
    rec = dict(card=card_line, wall_s=time.perf_counter() - t0,
               pickles=len([n for n in os.listdir(os.path.join(
                   gen_dir, 'eval')) if n.startswith('eval_')]),
               rows=len(rows), mean_row=dict(zip(header[2:],
                                                 vals[-1].tolist())))
    print('offline evaluation', json.dumps(rec), flush=True)
    if rec['pickles'] != SWEEP_SHAPES or len(rows) != SWEEP_SHAPES + 1 \
            or not np.isfinite(vals).all():
        fail('the offline evaluation did not score every sweep mesh')
    return rec


def _csv_scores(path):
    with open(path) as f:
        header, *rows = list(csv.reader(f))
    return header, {r[1]: np.asarray(r[2:], np.float64) for r in rows
                    if r[1] != 'Mean'}


def dist_phase(args, stencil3d, fused_fc0, card_line, sweep):
    """The distributed phase (module docstring, phase 9); ``sweep`` is
    sweep_phase's record: its checkpoint and its default-head 1-process
    sweep of the same 8 shapes, which the sharded sweep is held to."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    from list_tpu_torch.train.checkpoints import load_checkpoint
    root = args.dist_dir
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    cfg = default_config(**_sweep_flags(root, 'sweep_ranks'))
    os.makedirs(cfg.checkpoint_dir)
    shutil.copy(sweep['checkpoint'], os.path.join(cfg.checkpoint_dir,
                                                  cfg.test_checkpoint))

    # 2 gloo ranks; the small step's CPU references meanwhile
    port = _free_port()
    logs = [os.path.join(root, f'rank{r}.log') for r in range(DIST_WORLD)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, 'w') as log:
            procs.append(_spawn(args, ['--dist_rank', str(r), '--dist_port',
                                       str(port)], log))
    gcfg, gmodel, gbatch = _small_input(args.seed)
    t0 = time.perf_counter()
    refs = _reference_runs(gcfg, gmodel, gbatch, LISTExecutor)
    refs_s = time.perf_counter() - t0
    _join(procs, logs, 'dist')
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(root, f'rank{r}.json')) as f:
            ranks.append(json.load(f))
    for rec in ranks:
        print('dist rank', json.dumps(dict(
            card=card_line, rank=rec['rank'],
            step_s=[s['step_s'] for s in rec['train_steps']],
            peak_device_gb=[s['peak_device_gb'] for s in rec['train_steps']],
            sweep_wall_s=rec['sweep']['wall_s'],
            sweep_device_phase_s=rec['sweep']['device_phase_s'],
            sweep_peak_device_gb=rec['sweep']['peak_device_gb'],
            digests=rec['digests'])), flush=True)
    for key in ('digests', 'small_digests'):
        if any(r[key] != ranks[0][key] for r in ranks):
            fail(f'the ranks\' parameters, BatchNorm statistics or Adam '
                 f'moments differ ({key})')
    card = torch.load(os.path.join(root, 'small_rank0.pt'))
    check = card_gradient_check(gcfg, gmodel, gbatch, LISTExecutor,
                                card=card, refs=refs)
    if not check['ok']:
        fail('the 2-rank step disagrees with the 1-process step: '
             f'{json.dumps(check["bad"])}')

    # the sharded sweep's rows against the 1-process sweep's
    header, want = _csv_scores(os.path.join(HERE, sweep['sweeps'][1]['csv']))
    got = {}
    for rec in ranks:
        h, rows = _csv_scores(os.path.join(HERE, rec['sweep']['csv']))
        strided = sorted(want)[rec['rank']::DIST_WORLD]
        if h != header or sorted(rows) != strided or not os.path.basename(
                rec['sweep']['csv']).endswith(f'_p{rec["rank"]}.csv'):
            fail(f'rank {rec["rank"]}: CSV {rec["sweep"]["csv"]} with rows '
                 f'{sorted(rows)}, expected {strided}')
        got.update(rows)
    worst = max(float(np.max(np.abs(got[k] - v) / (2e-2 + 7e-2 * np.abs(v))))
                for k, v in want.items() if k in got)
    print('sharded sweep vs 1 process', json.dumps(dict(
        card=card_line, shapes=sorted(got), worst_err_over_tol=worst)),
        flush=True)
    if sorted(got) != sorted(want) or worst > 1:
        fail('the sharded sweep\'s rows are not the 1-process sweep\'s')

    # 1 NCCL rank, with the offline evaluation of the sharded sweep's
    # meshes meanwhile; then the split decode
    nlog = os.path.join(root, 'nccl.log')
    with open(nlog, 'w') as log:
        nproc = _spawn(args, ['--nccl_rank', '--dist_port',
                              str(_free_port())], log)
    mesh_dir = os.path.join(root, 'gt_mesh')
    test = SyntheticSDFDataset(cfg, 'test')
    for i in range(SWEEP_SHAPES):
        d = os.path.join(mesh_dir, 'synthetic', str(i))
        os.makedirs(d)
        test.get_testdata('synthetic', str(i), 0)['gt_mesh'].export(
            os.path.join(d, 'isosurf_scaled.obj'))
    offline = _offline_eval(
        os.path.dirname(os.path.join(HERE, ranks[0]['sweep']['csv'])),
        mesh_dir, card_line)
    _join([nproc], [nlog], 'nccl')
    with open(os.path.join(root, 'nccl.json')) as f:
        nccl = json.load(f)
    print('nccl rank', json.dumps(dict(card=card_line, **nccl)), flush=True)
    if not (nccl['backend'] == 'nccl' and nccl['nccl_identical']):
        fail('the 1-rank NCCL step is not bit-identical to the step with no '
             'process group')
    if not (nccl['checkify_identical'] and nccl['checkify_raised']
            and nccl['checkify_state_kept']):
        fail('--checkify on the card: the clean step differs from the '
             'unchecked one, or the NaN step did not raise '
             'FloatingPointError, or it changed the parameters, BatchNorm '
             'statistics, Adam moments or step')
    model = LIST.from_config(cfg)
    load_checkpoint(sweep['checkpoint'], model)
    split = split_decode_check(default_config(vox_res=128, sdf_scale=10.0),
                               model, test.get_testdata(
                                   'synthetic', '0', 0)['rgb_image'],
                               fused_fc0, stencil3d, card_line)
    return dict(ranks=ranks, card_gradient_check=check,
                cpu_references_s=refs_s, nccl=nccl,
                sharded_sweep_worst=worst, offline=offline, split=split,
                wall_s=time.perf_counter() - t_phase)


# ---- the multi-card mode (--cards N) ----------------------------------------

# shapes a card in the NCCL ranks' training tree: one epoch of each job
# takes 3 steps or more, and no step waits for a checkpoint that rank 0
# writes at an epoch's end
CARDS_TREE_SHAPES = 48
CARDS_CAT = '03001627'
# per-card batches of the NCCL ranks' train_torch.py runs (global: x N)
CARDS_JOBS = (('stage 2, 2 a card', 'network.models.LIST', 2),
              ('stage 2, 8 a card', 'network.models.LIST', 8),
              ('stage 1, 16 a card', 'network.models.CoarseNet', 16))
CARDS_DECODE_REPS = 3  # timed split decodes a plan, after one warm
CARDS_RANK_TIMEOUT_S = 600
# the training tree: written by a process of its own while the card
# phases run, with stage 2's occupancy caches, so that the ranks only read
TREE_SCRIPT = '''
import sys
from list_tpu_torch.config import default_config
from list_tpu_torch.data import IM2SDF, generate_synthetic_shapenet
root, n, cat = sys.argv[1], int(sys.argv[2]), sys.argv[3]
generate_synthetic_shapenet(root, cats=(cat,), n_shapes=n, n_views=1,
                            img_res=224)
IM2SDF(default_config(image_dir=root + '/images/',
                      h5_dir=root + '/sampled_points/',
                      split_dir=root + '/split', catlist=[cat], viewnum=1,
                      vox_res=128), 'train').ensure_occupancies()
'''


def _sync(devs) -> None:
    for d in devs:
        torch.cuda.synchronize(d)


def _current_is_first(where: str) -> None:
    if torch.cuda.current_device() != 0:
        fail(f'{where}: the current device moved to cuda:'
             f'{torch.cuda.current_device()}')


def cards_kernel_phase(devs, lines, stencil3d, fused_fc0):
    """The kernel phase's checks on each card of ``devs`` while cuda:0
    stays the current device: K2 at the train step's shapes (batch 8,
    forward and the dx shape), K3 at its three shapes, K1 at the
    production decode (n = 128^3) and K4 at one slab (n = 64 x 128^2),
    and the differentiable conv3x3x3 (K2's dx and K3 inside
    Conv3x3x3Fn.backward, batch 2), the BatchNorm path at its shapes
    (``bn_phase``), the perceptual sample (``percep_phase``) and the
    voxel work (``voxel_phase``); each
    against its plain version within the kernel phase's tolerances and
    1e-2 + 1e-2 |plain| (BatchNorm: BN_LIMITS; the sample: float64), and
    timed with CUDA events on its card; every kernel launched."""
    from list_tpu_torch.ops.cuda import batch_norm, percep, voxel
    rows = []
    for d in devs:
        reset_launch_counts()
        bn_step, bn_request = bn_phase(d, batch_norm, reps=3)
        with torch.inference_mode():
            conv = conv_phase(d, stencil3d, 8, TRAIN_CONV_SHAPES,
                              TRAIN_CONV_UNIT, plain_reps=2)
            dk = dk_phase(d, stencil3d)
            head = head_phase(d, fused_fc0, 128 ** 3)
            torch.cuda.empty_cache()
            mlp = mlp_phase(d, fused_fc0, 64 * 128 ** 2)
            torch.cuda.empty_cache()
            sample = percep_phase(d, percep)
            vox = voxel_phase(d, voxel)
        grads = grad_fn_phase(d, stencil3d)
        counts = launch_counts()
        _current_is_first(f'the kernels on {d}')
        within = dict(
            conv3x3x3=all(r['within_head_tol'] for r in conv['per_shape']),
            conv3x3x3_dk=all(r['within_head_tol'] for r in dk['per_shape']),
            conv3x3x3_dx=all(r['dx_within_head_tol'] for r in grads),
            conv3x3x3_dk_backward=all(r['dk_within_head_tol']
                                      for r in grads),
            fused_stack_head=head['ok'], fused_fc0_mlp=mlp['ok'],
            batch_norm=all(r['ok'] for r in bn_step['per_shape']
                           + bn_request['per_shape']),
            percep_sample=sample['ok'], voxel_taps=vox['ok'])
        row = dict(device=str(d), card=lines[d.index], launches=counts,
                   within_1e2_plus_1e2_plain=within,
                   ms=dict(conv3x3x3_step=conv['ms'],
                           conv3x3x3_dk_step=dk['ms'],
                           fused_stack_head=head['ms'],
                           fused_fc0_mlp=mlp['ms'],
                           batch_norm_step=bn_step['ms'],
                           batch_norm_request=bn_request['ms'],
                           percep_sample=sample['ms'],
                           voxel_taps=vox['ms']),
                   max_abs_err=dict(conv3x3x3=conv['max_abs_err'],
                                    conv3x3x3_dk=dk['max_abs_err'],
                                    fused_stack_head=head['max_abs_err'],
                                    fused_fc0_mlp=mlp['max_abs_err'],
                                    batch_norm=bn_step['max_abs_err'],
                                    percep_sample=sample['max_abs_err'],
                                    voxel_taps=vox['max_abs_err']),
                   conv=conv, dk=dk, head=head, mlp=mlp, gradients=grads,
                   batch_norm=[bn_step, bn_request], percep_sample=sample,
                   voxel_taps=vox)
        print('card kernels', json.dumps({k: row[k] for k in (
            'device', 'card', 'launches', 'within_1e2_plus_1e2_plain', 'ms',
            'max_abs_err')}), flush=True)
        if not all(within.values()):
            fail(f'a kernel on {d} is off its plain version by more than '
                 f'1e-2 + 1e-2 |plain|: {within}')
        if not all(counts.values()):
            fail(f'a kernel was not launched on {d}: {counts}')
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _threaded_decode(ex, enc, slab, head):
    """``LISTExecutor._decode``'s split with a host thread a card (each
    with its card current) instead of one thread: for the comparison
    only."""
    from concurrent.futures import ThreadPoolExecutor
    from list_tpu_torch.train import executors
    devs = ex.decode_devices
    rows = ex.vox_res // len(devs)
    inputs = [(ex.model.sdf_decoder if d == ex.device
               else copy.deepcopy(ex.model.sdf_decoder).to(d),
               [f.to(d) for f in enc['vox_feat']],
               [f.to(d) for f in enc['feat_l2']], enc['trans_mat'].to(d))
              for d in devs]
    inference = torch.is_inference_mode_enabled()

    def decode(i):
        with torch.cuda.device(devs[i]), torch.inference_mode(inference):
            return torch.cat(list(executors.dense_grid_slabs(
                *inputs[i], ex.vox_res, slab=slab,
                compute_dtype=ex.compute_dtype, bb_min=ex.bb_min,
                bb_max=ex.bb_max, use_pallas=head,
                x_range=(i * rows, (i + 1) * rows))))

    with ThreadPoolExecutor(len(devs)) as pool:
        parts = list(pool.map(decode, range(len(devs))))
    return torch.cat([p.to(ex.device) for p in parts])


def _timed_decodes(devs, decode, reps=CARDS_DECODE_REPS):
    """``decode()`` 1 + ``reps`` times, each between synchronizations of
    ``devs``: the median host-clock seconds of a decode and, per card, the
    median CUDA-event seconds of its ``dense_grid_slabs`` call(s), from
    before its first slab to after its last (events on the card's stream,
    recorded with it current); then one more decode as a probe of the
    host: per card, the host seconds spent in its slabs, and the count and
    host seconds of the host arrays made tensors there
    (``numpy_uploads``: an upload from pageable memory waits on the card's
    stream; none once the constants are on the cards)."""
    from list_tpu_torch.train import executors
    from tools.torch_decode_probe import numpy_uploads
    real = executors.dense_grid_slabs
    marks = []

    def timed(*a, **kw):
        it = real(*a, **kw)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        mark = [None, s, e, 0.0]
        marks.append(mark)
        while True:
            t0 = time.perf_counter()
            if mark[0] is None:
                mark[0] = torch.cuda.current_device()
                s.record()
            try:
                out = next(it)
            except StopIteration:
                return
            e.record()
            mark[3] += time.perf_counter() - t0
            yield out

    executors.dense_grid_slabs = timed
    host, per_card = [], []
    try:
        for rep in range(reps + 2):
            marks.clear()
            _sync(devs)
            t0 = time.perf_counter()
            if rep <= reps:
                grid = decode()
                _sync(devs)
                host.append(time.perf_counter() - t0)
            else:
                with numpy_uploads() as uploads:
                    grid = decode()
                _sync(devs)
            card = {}
            for i, s, e, _ in marks:
                card[f'cuda:{i}'] = card.get(f'cuda:{i}', 0.0) \
                    + s.elapsed_time(e) / 1e3
            per_card.append(card)
    finally:
        executors.dense_grid_slabs = real
    keys = sorted(per_card[-1])
    probe = {k: dict(host_s=sum(m[3] for m in marks
                                if f'cuda:{m[0]}' == k),
                     uploads=sum(1 for u in uploads if u[0] == k),
                     upload_s=sum(u[1] for u in uploads if u[0] == k))
             for k in keys}
    probe['host arrays'] = len(uploads)
    return grid, dict(
        host_s=float(np.median(host[1:])), host_all_s=host,
        card_s={k: float(np.median([c[k] for c in per_card[1:-1]]))
                for k in keys}, probe=probe)


def cards_decode_phase(args, devs, lines, model, imgs, gt):
    """The dense decode split over ``devs`` (``--mesh_shape N`` and
    ``--mesh_shape 1 N``) against one card (cuda:0) from the same encoding:
    at 128^3 and 256^3 (the 128^3 features), the grid bit for bit, the K1
    launches, and the decode's host-clock and per-card event times on one
    card, split as the executor dispatches it (from one host thread), and
    split with a host thread a card (``_threaded_decode``); one more split
    decode under ``torch.cuda.set_sync_debug_mode('error')`` and the
    upload probe (``_no_waits``); then ``predict_grid`` under both mesh
    shapes, ``predict_grid_batch`` of two images and ``test`` of one
    against one card's."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.train import LISTExecutor
    n = len(devs)
    shapes = ([n], [1, n])
    grid_kw = dict(fetch_dtype='float32', fetch_mode='grid')
    out = dict(decode={})
    img = torch.as_tensor(imgs[0], device=devs[0])
    with torch.inference_mode():
        enc = model.encode(img)
    for R in (128, 256):
        mk = lambda **kw: LISTExecutor(default_config(  # noqa: E731
            vox_res=R, sdf_scale=10.0, **kw), model)
        one = mk()
        split = {tuple(s): mk(mesh_shape=s) for s in shapes}
        for s, ex in split.items():
            if ex.decode_devices != (devs if n > 1 else [one.device]):
                fail(f'--mesh_shape {list(s)}: decode devices '
                     f'{ex.decode_devices}, expected {devs}')
        ex = split[(n,)]
        plan1, plan = one._dense_plan(1), ex._dense_plan(n)
        rec = dict(card=lines, R=R, plan_one_card=plan1, plan_split=plan)
        with torch.inference_mode():
            for d in devs:
                torch.cuda.reset_peak_memory_stats(d)
            reset_launch_counts()
            g1, rec['one_card'] = _timed_decodes(
                devs, lambda: one._decode(enc, *plan1))
            rec['one_card_launches'] = launch_counts()
            reset_launch_counts()
            g, rec['split'] = _timed_decodes(
                devs, lambda: ex._decode(enc, *plan))
            rec['split_launches'] = launch_counts()
            gt_, rec['split_threads'] = _timed_decodes(
                devs, lambda: _threaded_decode(ex, enc, *plan))
            gw, rec['split_no_waits_s'] = _no_waits(
                f'the {R}^3 split decode', lambda: ex._decode(enc, *plan))
            rec['peak_device_gb'] = {
                str(d): torch.cuda.max_memory_allocated(d) / 1e9
                for d in devs}
            err = float((g - g1).abs().max())
            rec.update(bitwise=bool(torch.equal(g, g1)),
                       threads_bitwise=bool(torch.equal(gt_, g)),
                       no_waits_bitwise=bool(torch.equal(gw, g)),
                       max_abs_err=err)
            del g, g1, gt_, gw
        want = decode_launches(True, R, *plan, meshes=CARDS_DECODE_REPS + 2,
                               cards=n)
        want1 = decode_launches(True, R, *plan1,
                                meshes=CARDS_DECODE_REPS + 2)
        print('cards decode', json.dumps(rec), flush=True)
        if rec['split_launches'] != want or rec['one_card_launches'] != want1:
            fail(f'{R}^3 decode: launches {rec["split_launches"]} split and '
                 f'{rec["one_card_launches"]} on one card, expected {want} '
                 f'and {want1}')
        if not (rec['bitwise'] and rec['threads_bitwise']
                and rec['no_waits_bitwise']):
            fail(f'{R}^3: the split decode is not one card\'s grid bit for '
                 'bit')
        # predict_grid under both mesh shapes
        ref = one.predict_grid(imgs[0], **grid_kw)
        rec_p = dict(R=R, decode_s_one_card=one.timings['decode_s'])
        for s, sx in split.items():
            got = sx.predict_grid(imgs[0], **grid_kw)
            rec_p[f'mesh_shape {list(s)}'] = dict(
                decode_s=sx.timings['decode_s'],
                bitwise=bool(np.array_equal(got, ref)),
                max_abs_err=float(np.abs(got - ref).max()))
            if not (np.isfinite(got).all()
                    and rec_p[f'mesh_shape {list(s)}']['max_abs_err']
                    <= 5e-4 + 2e-2 * float(np.abs(ref).max())):
                fail(f'predict_grid at {R}^3 under --mesh_shape {list(s)} '
                     'disagrees with one card\'s')
        print('cards predict_grid', json.dumps(rec_p), flush=True)
        out['decode'][R] = dict(rec, predict_grid=rec_p)
        del one, split, ex, ref
        torch.cuda.empty_cache()

    # predict_grid_batch and test at 128^3
    mk = lambda **kw: LISTExecutor(default_config(  # noqa: E731
        vox_res=128, sdf_scale=10.0, **kw), model)
    one = mk()
    batch = np.concatenate(imgs[:2])
    ref = one.predict_grid_batch(batch, **grid_kw)
    np.random.seed(args.seed)
    (mesh1, _), score1 = one.test({'rgb_image': imgs[0], 'gt_mesh': gt},
                                  eval_pred=True)
    other = {}
    for s in shapes:
        ex = mk(mesh_shape=s)
        reset_launch_counts()
        got = ex.predict_grid_batch(batch, **grid_kw)
        np.random.seed(args.seed)
        (mesh, _), score = ex.test({'rgb_image': imgs[0], 'gt_mesh': gt},
                                   eval_pred=True)
        counts = launch_counts()
        other[f'mesh_shape {list(s)}'] = r = dict(
            batch_bitwise=bool(np.array_equal(got, ref)),
            batch_max_abs_err=float(np.abs(got - ref).max()),
            mesh_identical=bool(np.array_equal(mesh.vertices, mesh1.vertices)
                                and np.array_equal(mesh.faces, mesh1.faces)),
            vertices=len(mesh.vertices), scores=score,
            scores_one_card=score1, launches=counts)
        # a batch of 2 and a test: two encodes, three meshes
        want = decode_launches(True, 128, *ex._dense_plan(n), meshes=3,
                               encodes=(2, 1), cards=n)
        if counts != want:
            fail(f'--mesh_shape {list(s)}: a batch of 2 and a test '
                 f'launched {counts}, expected {want}')
        if r['batch_max_abs_err'] > 5e-4 + 2e-2 * float(np.abs(ref).max()) \
                or not r['vertices'] or not score:
            fail(f'--mesh_shape {list(s)}: predict_grid_batch or test '
                 'disagrees with one card\'s')
        del ex
    print('cards batch and test', json.dumps(other), flush=True)
    out['batch_and_test'] = other
    return out


def cards_sweep_phase(devs, root, ckpt, stencil3d, fused_fc0):
    """``test_all`` over the 8 synthetic test shapes (default head, band
    fetch, ``--eval_pred``) from ``ckpt`` on one card, then under
    ``--mesh_shape N`` and ``--mesh_shape 1 N``: launch counts (K2 5 and
    K1 R / slab a shape) and every row against one card's within the
    sweep tolerance (rtol 7e-2, atol 2e-2)."""
    from list_tpu_torch.config import default_config
    n = len(devs)
    runs = {}
    for label, kw in (('one card', {}), (f'--mesh_shape {n}',
                                         dict(mesh_shape=[n])),
                      (f'--mesh_shape 1 {n}', dict(mesh_shape=[1, n]))):
        name = 'sweep_' + label.replace(' ', '_').replace('-', '')
        cfg = default_config(**_sweep_flags(root, name), **kw)
        os.makedirs(cfg.checkpoint_dir)
        shutil.copy(ckpt, os.path.join(cfg.checkpoint_dir,
                                       cfg.test_checkpoint))
        rec = sweep_run(cfg, label, stencil3d, fused_fc0)
        k1 = 1 if not kw else n  # slab 128 on one card, 128 / n split
        want = decode_launches(slab=128 // k1, meshes=SWEEP_SHAPES,
                               encodes=(1,) * SWEEP_SHAPES, cards=k1)
        if rec['launches'] != want:
            fail(f'sweep {label}: launches {rec["launches"]}, expected '
                 f'{want}')
        runs[label] = rec
    header, want = _csv_scores(os.path.join(HERE, runs['one card']['csv']))
    for label, rec in runs.items():
        h, got = _csv_scores(os.path.join(HERE, rec['csv']))
        worst = max(float(np.max(np.abs(got[k] - v)
                                 / (2e-2 + 7e-2 * np.abs(v))))
                    for k, v in want.items())
        rec['worst_err_over_tol'] = worst
        rec['identical_rows'] = h == header and all(
            np.array_equal(got[k], v) for k, v in want.items())
        if h != header or sorted(got) != sorted(want) or worst > 1:
            fail(f'sweep {label}: rows are not the one-card sweep\'s')
    print('cards sweeps', json.dumps({k: dict(
        wall_s=r['wall_s'], device_phase_s=r['device_phase_s'],
        fresh_meshes_per_s=r['fresh_meshes_per_s'],
        later_decode_s=r['later_decode_s'],
        worst_err_over_tol=r['worst_err_over_tol'],
        identical_rows=r['identical_rows']) for k, r in runs.items()}),
        flush=True)
    return runs


def _cards_train_flags(args, tree, name, model, per_card):
    """train_torch.py's flags of one NCCL job on the synthetic ShapeNet
    tree: the global batch of ``per_card`` a card, the reference stage-2
    recipe (128^3, 32,768 queries, remat, --remat_save_samples 1, 4 query
    chunks) or stage 1's, one epoch, no periodic checkpoint or testlist
    eval."""
    exp = name.replace(' ', '_').replace(',', '')
    flags = ['--model', model, '--image_dir', f'{tree}/images/',
             '--h5_dir', f'{tree}/sampled_points/', '--mesh_dir',
             f'{tree}/mesh/', '--split_dir', f'{tree}/split',
             '--testlist_file', '', '--catlist', CARDS_CAT,
             '--viewnum', '1', '--img_res', '224', '--train_batch_size',
             str(per_card * args.cards), '--epochs', '1',
             '--save_every_epoch', '100', '--test_every_epoch', '100',
             '--output_dir', os.path.join(args.dist_dir, 'train') + '/',
             '-e', exp, '--seed', str(args.seed), '--multihost', '1']
    if model.endswith('LIST'):
        return flags + ['--dataset', 'datasets.Datasets.IM2SDF',
                        '--vox_res', '128', '--sample_point_density',
                        '32768', '--sdf_scale', '10', '--remat', '1',
                        '--remat_save_samples', '1', '--train_query_chunks',
                        '4']
    return flags + ['--dataset', 'datasets.Datasets.IM2PointFarthest']


def card_rank(args, stencil3d, fused_fc0):
    """One NCCL rank of the multi-card mode, on cuda:{rank} (run by
    ``cards_ranks_phase`` as ``chip_smoke.py --cards N --card_rank R``):
    ``train_torch.main`` with ``--multihost 1`` for each of CARDS_JOBS
    (every step's launches, step_s and peak memory; the state digests
    after it), the small step at a global batch of 4 (rank 0 keeps its
    result), and ``infer_torch.main`` with ``--multihost 1`` over this
    rank's strided share of the 8 synthetic test shapes; writes its record
    to ``<dist_dir>/rank<R>.json``."""
    import importlib
    from list_tpu_torch.parallel import multihost
    from list_tpu_torch.train.executors import (CoarseNetExecutor,
                                                LISTExecutor)
    os.environ.update(COORDINATOR_ADDRESS=f'127.0.0.1:{args.dist_port}',
                      NUM_PROCESSES=str(args.cards),
                      PROCESS_ID=str(args.card_rank))
    train_torch = importlib.import_module('train_torch')
    infer_torch = importlib.import_module('infer_torch')
    rank = args.card_rank
    rec = dict(rank=rank, jobs={})
    for name, model, per_card in CARDS_JOBS:
        flags = _cards_train_flags(args, args.tree, name, model, per_card)
        Executor = LISTExecutor if model.endswith('LIST') \
            else CoarseNetExecutor
        seen = []
        run = driver_run(None, f'rank {rank}: {name}', Executor, stencil3d,
                         fused_fc0, run=lambda: train_torch.main(flags),
                         seen=seen)
        want = launches() if Executor is not LISTExecutor \
            else step_launches(batch=per_card, group=args.cards > 1)
        steps = [e for e in run['events'] if e['kind'] == 'train']
        if len(steps) < 3 or any(e['launches'] != want for e in steps):
            fail(f'rank {rank} {name}: {len(steps)} steps, launches '
                 f'{[e["launches"] for e in steps]}, expected {want} a step')
        if not all(np.isfinite(v) for e in steps
                   for v in e['losses'].values()):
            fail(f'rank {rank} {name}: a loss is not finite')
        ex = seen[-1]
        rec['jobs'][name] = dict(
            global_batch=per_card * args.cards, device=str(ex.device),
            process_info=multihost.process_info(),
            step_s=[e['step_s'] for e in steps],
            peak_device_gb=[e['peak_device_gb'] for e in steps],
            launches_per_step=steps[0]['launches'], wall_s=run['wall_s'],
            digests=_digests(ex))
        if ex.device != torch.device('cuda', rank) \
                or torch.cuda.current_device() != rank:
            fail(f'rank {rank} {name}: ran on {ex.device}')
        del ex, seen, run
        torch.cuda.empty_cache()

    gcfg, model, gbatch = _small_input(args.seed)
    ex = LISTExecutor(gcfg, model)
    small = _step_run(ex, ex.train(gbatch)[1])
    rec['small_digests'] = _digests(ex)
    if rank == 0:
        torch.save(small, os.path.join(args.dist_dir, 'small_rank0.pt'))
    del ex, model, small
    torch.cuda.empty_cache()

    flags = ['--model', 'network.models.LIST', '--dataset',
             'datasets.Datasets.Synthetic', '--vox_res', '128',
             '--sdf_scale', '10', '--eval_pred', '-e', 'sweep',
             '--output_dir', os.path.join(args.dist_dir, 'sweep_ranks') + '/',
             '--multihost', '1']
    shapes = SWEEP_SHAPES // args.cards
    rec['sweep'] = sweep_run(None, f'rank {rank} of {args.cards}', stencil3d,
                             fused_fc0, shapes=shapes,
                             run=lambda: infer_torch.main(flags))
    want = decode_launches(meshes=shapes, encodes=(1,) * shapes)
    if rec['sweep']['launches'] != want:
        fail(f'rank {rank} sweep: launches {rec["sweep"]["launches"]}, '
             f'expected {want}')
    multihost.sync_global_devices('done')
    multihost.shutdown()
    with open(os.path.join(args.dist_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(rec, f, default=float)


def cards_ranks_phase(args, lines, ckpt, tree_proc, reference_csv):
    """N NCCL ranks, rank r on cuda:r, each running ``card_rank``; then
    their states per job bit-identical, the small step held to one process
    (``card_gradient_check``, references on the CPU after the ranks), the
    sharded sweep's ``_p{rank}.csv`` rows against the one-card sweep's, and
    the offline evaluation of the ranks' meshes."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset
    from list_tpu_torch.train import LISTExecutor
    root = args.dist_dir
    n = args.cards
    cfg = default_config(**_sweep_flags(root, 'sweep_ranks'))
    os.makedirs(cfg.checkpoint_dir)
    shutil.copy(ckpt, os.path.join(cfg.checkpoint_dir, cfg.test_checkpoint))
    t0 = time.perf_counter()
    if tree_proc.wait() != 0:
        fail('the synthetic ShapeNet tree was not written')
    tree_wait_s = time.perf_counter() - t0

    port = _free_port()
    logs = [os.path.join(root, f'rank{r}.log') for r in range(n)]
    procs = []
    t0 = time.perf_counter()
    for r, path in enumerate(logs):
        with open(path, 'w') as log:
            procs.append(_spawn(args, [
                '--cards', str(n), '--card_rank', str(r), '--dist_port',
                str(port), '--tree', os.path.join(root, 'tree')], log))
    _join(procs, logs, 'cards', timeout=CARDS_RANK_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(root, f'rank{r}.json')) as f:
            ranks.append(json.load(f))
    for rec in ranks:
        print('cards rank', json.dumps(dict(
            card=lines[rec['rank']], rank=rec['rank'],
            jobs={k: {kk: v[kk] for kk in ('global_batch', 'device',
                                           'step_s', 'peak_device_gb',
                                           'launches_per_step', 'wall_s')}
                  for k, v in rec['jobs'].items()},
            sweep=dict(wall_s=rec['sweep']['wall_s'],
                       device_phase_s=rec['sweep']['device_phase_s'],
                       fresh_meshes_per_s=rec['sweep'][
                           'fresh_meshes_per_s'],
                       peak_device_gb=rec['sweep']['peak_device_gb']))),
            flush=True)
    for name, *_ in CARDS_JOBS:
        if any(r['jobs'][name]['digests'] != ranks[0]['jobs'][name]['digests']
               for r in ranks):
            fail(f'{name}: the ranks\' parameters, BatchNorm statistics or '
                 'Adam moments differ')
    if any(r['small_digests'] != ranks[0]['small_digests'] for r in ranks):
        fail('the small step: the ranks\' states differ')

    gcfg, gmodel, gbatch = _small_input(args.seed)
    t0 = time.perf_counter()
    refs = _reference_runs(gcfg, gmodel, gbatch, LISTExecutor)
    refs_s = time.perf_counter() - t0
    check = card_gradient_check(
        gcfg, gmodel, gbatch, LISTExecutor, refs=refs,
        card=torch.load(os.path.join(root, 'small_rank0.pt')))
    if not check['ok']:
        fail(f'the {n}-rank small step disagrees with the 1-process step: '
             f'{json.dumps(check["bad"])}')

    header, want = _csv_scores(os.path.join(HERE, reference_csv))
    got = {}
    for rec in ranks:
        h, rows = _csv_scores(os.path.join(HERE, rec['sweep']['csv']))
        strided = sorted(want)[rec['rank']::n]
        name = f'_p{rec["rank"]}.csv' if n > 1 else f'{SWEEP_CAT}.csv'
        if h != header or sorted(rows) != strided or not os.path.basename(
                rec['sweep']['csv']).endswith(name):
            fail(f'rank {rec["rank"]}: CSV {rec["sweep"]["csv"]} with rows '
                 f'{sorted(rows)}, expected {strided}')
        got.update(rows)
    worst = max(float(np.max(np.abs(got[k] - v) / (2e-2 + 7e-2 * np.abs(v))))
                for k, v in want.items() if k in got)
    print('cards sharded sweep vs one card', json.dumps(dict(
        shapes=sorted(got), worst_err_over_tol=worst)), flush=True)
    if sorted(got) != sorted(want) or worst > 1:
        fail('the sharded sweep\'s rows are not the one-card sweep\'s')
    mesh_dir = os.path.join(root, 'gt_mesh')
    test = SyntheticSDFDataset(cfg, 'test')
    for i in range(SWEEP_SHAPES):
        d = os.path.join(mesh_dir, 'synthetic', str(i))
        os.makedirs(d)
        test.get_testdata('synthetic', str(i), 0)['gt_mesh'].export(
            os.path.join(d, 'isosurf_scaled.obj'))
    offline = _offline_eval(
        os.path.dirname(os.path.join(HERE, ranks[0]['sweep']['csv'])),
        mesh_dir, lines[0])
    return dict(ranks=ranks, tree_wait_s=tree_wait_s, ranks_s=ranks_s,
                card_gradient_check=check, cpu_references_s=refs_s,
                sharded_sweep_worst=worst, offline=offline)


def cards_last_card_phase(args, dev, line, model, img, gt):
    """One process on ``dev`` (the last card) while cuda:0 stays current:
    one warm and one timed full-width stage-2 step (batch 8 x 32,768,
    remat, --remat_save_samples 1, 4 query chunks) and one 128^3 mesh
    through ``LISTExecutor.test`` with the sweep's weights; launches per
    step and per mesh asserted."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset, collate
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    tcfg = default_config(vox_res=128, train_batch_size=8,
                          sample_point_density=32768, sdf_scale=10.0,
                          remat_save_samples=1)
    ds = SyntheticSDFDataset(tcfg, 'train', n_shapes=8)
    batch = collate([ds[i] for i in range(8)])
    torch.manual_seed(args.seed)
    ex = LISTExecutor(tcfg, LIST.from_config(tcfg), device=dev)
    steps = []
    for i in range(2):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        _, losses = ex.train(batch)
        steps.append(dict(step_s=ex.timings['step_s'],
                          peak_device_gb=torch.cuda.max_memory_allocated(dev)
                          / 1e9, launches=launch_counts(),
                          losses={k: float(v) for k, v in losses.items()}))
        _current_is_first(f'a train step on {dev}')
        if steps[-1]['launches'] != step_launches() or not all(
                np.isfinite(v) for v in steps[-1]['losses'].values()):
            fail(f'a train step on {dev}: {steps[-1]}')
    del ex
    torch.cuda.empty_cache()
    mex = LISTExecutor(default_config(vox_res=128, sdf_scale=10.0),
                       copy.deepcopy(model), device=dev)
    reset_launch_counts()
    np.random.seed(args.seed)
    (mesh, values), score = mex.test({'rgb_image': img, 'gt_mesh': gt},
                                     eval_pred=True)
    counts = launch_counts()
    _current_is_first(f'a mesh on {dev}')
    rec = dict(card=line, device=str(dev), train_steps=steps,
               mesh=dict(vertices=len(mesh.vertices), **mex.timings,
                         metrics=score, launches=counts))
    print('cards last card', json.dumps(rec), flush=True)
    if counts != decode_launches(encodes=(1,)) or not len(mesh.vertices) \
            or not score \
            or not np.isfinite(values).all():
        fail(f'the mesh on {dev}: launches {counts}, '
             f'{len(mesh.vertices)} vertices, scores {score}')
    return rec


def cards_main(args, kind, build, native, stencil3d, fused_fc0):
    """``--cards N``: the port across N cards of one machine (module
    docstring, "The multi-card mode")."""
    from list_tpu_torch.config import default_config
    from list_tpu_torch.data import SyntheticSDFDataset
    from list_tpu_torch.device import cards
    from list_tpu_torch.ops.cuda import KERNEL_SOURCES
    from list_tpu_torch.utils.meshio import make_icosphere
    n = args.cards
    t_start = time.perf_counter()
    if torch.cuda.device_count() < n:
        fail(f'--cards {n} needs {n} cards, this machine has '
             f'{torch.cuda.device_count()}')
    if SWEEP_SHAPES % n or 4 % n:
        fail(f'--cards {n}: the sweep\'s {SWEEP_SHAPES} shapes and the small '
             'step\'s global batch of 4 must divide over the cards')
    devs = [torch.device('cuda', i) for i in range(n)]
    torch.cuda.set_device(0)
    lines = cards()
    for line in lines:
        print(line, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'devices {torch.cuda.device_count()}, --cards {n}', flush=True)
    args.dist_dir = os.path.join(HERE, 'build', 'chip_smoke_cards')
    shutil.rmtree(args.dist_dir, ignore_errors=True)
    os.makedirs(args.dist_dir)
    tree_log = open(os.path.join(args.dist_dir, 'tree.log'), 'w')
    tree_proc = subprocess.Popen(
        [sys.executable, '-c', TREE_SCRIPT,
         os.path.join(args.dist_dir, 'tree'), str(CARDS_TREE_SHAPES * n),
         CARDS_CAT], cwd=HERE, stdout=tree_log, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        nat = threading.Thread(target=native.have_native)
        nat.start()
        try:
            build.build_all(KERNEL_SOURCES)
        except RuntimeError as e:
            fail(str(e))
        nat.join()
        if not native.have_native():
            fail('the native mesh library did not build')
        print(f'build_s {time.perf_counter() - t0:.1f}', flush=True)
        t0 = time.perf_counter()
        kernels = cards_kernel_phase(devs[1:] or devs, lines, stencil3d,
                                     fused_fc0)
        kernels_s = time.perf_counter() - t0
        print(f'cards kernel phase {kernels_s:.1f} s', flush=True)

        t0 = time.perf_counter()
        base = _sweep_flags(args.dist_dir, 'checkpoint')
        model, ex, _, ckpt = _sweep_checkpoint(args, base)
        del ex
        test = SyntheticSDFDataset(default_config(**base), 'test')
        imgs = [test.get_testdata('synthetic', str(i), 0)['rgb_image']
                for i in range(2)]
        gt = make_icosphere(radius=0.3)
        decode = cards_decode_phase(args, devs, lines, model, imgs, gt)
        sweeps = cards_sweep_phase(devs, args.dist_dir, ckpt, stencil3d,
                                   fused_fc0)
        decode_s = time.perf_counter() - t0
        print(f'cards decode and sweep phases {decode_s:.1f} s', flush=True)
        torch.cuda.empty_cache()

        ranks = cards_ranks_phase(args, lines, ckpt, tree_proc,
                                  sweeps['one card']['csv'])
        last = cards_last_card_phase(args, devs[-1], lines[-1], model,
                                     imgs[0], gt)
    finally:
        if tree_proc.poll() is None:
            tree_proc.kill()
        tree_proc.wait()
        tree_log.close()
    summary = dict(
        cards=lines[:n], kernels_on_cards={
            r['device']: dict(ms=r['ms'], max_abs_err=r['max_abs_err'],
                              launches=r['launches']) for r in kernels},
        decode={R: dict(one_card_s=d['one_card'], split_s=d['split'],
                        split_threads_s=d['split_threads'],
                        bitwise=d['bitwise'])
                for R, d in decode['decode'].items()},
        step_s={name: {r['rank']: r['jobs'][name]['step_s']
                       for r in ranks['ranks']} for name, *_ in CARDS_JOBS},
        last_card=dict(step_s=[s['step_s'] for s in last['train_steps']]),
        phase_s=dict(kernels=kernels_s, decode_and_sweeps=decode_s,
                     ranks=ranks['ranks_s']),
        total_s=time.perf_counter() - t_start)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(dict(summary, kind=kind, kernels=kernels, decode=decode,
                           sweeps=sweeps, ranks=ranks, last_card=last), f,
                      indent=1, default=float)
    print(f'total_s {summary["total_s"]:.1f}', flush=True)
    print(json.dumps({'cards': summary}, default=float), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': n}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--report', default=None,
                    help='also write the run\'s numbers to this JSON file')
    # the distributed phase's own processes (dist_phase starts them)
    ap.add_argument('--dist_dir', default=os.path.join(
        HERE, 'build', 'chip_smoke_dist'), help=argparse.SUPPRESS)
    ap.add_argument('--dist_rank', type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument('--dist_port', type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument('--nccl_rank', action='store_true',
                    help=argparse.SUPPRESS)
    ap.add_argument('--cards', type=int, default=0,
                    help='the multi-card mode over cuda:0 .. N-1 (N cards '
                    'needed)')
    # the multi-card mode's own processes (cards_ranks_phase starts them)
    ap.add_argument('--card_rank', type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
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
        from list_tpu_torch.ops.cuda import (KERNEL_SOURCES, batch_norm,
                                             build, fused_fc0, percep,
                                             stencil3d, voxel)
        from list_tpu_torch.ops.dense_grid import dense_grid_sdf
        from list_tpu_torch.train import LISTExecutor
        from list_tpu_torch.utils.meshio import make_icosphere
    except ImportError as e:
        fail(f'the list_tpu_torch package is not beside chip_smoke.py ({e})')
    if args.dist_rank is not None:
        return dist_rank(args, stencil3d, fused_fc0)
    if args.nccl_rank:
        return nccl_rank(args)
    if args.card_rank is not None:
        return card_rank(args, stencil3d, fused_fc0)
    if args.cards:
        return cards_main(args, torch.cuda.get_device_name(0), build, native,
                          stencil3d, fused_fc0)

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
        conv_train = conv_phase(dev, stencil3d, 8, TRAIN_CONV_SHAPES,
                                TRAIN_CONV_UNIT, plain_reps=2)
        dk = dk_phase(dev, stencil3d)
    grads_on_card = grad_fn_phase(dev, stencil3d)
    torch.cuda.empty_cache()
    bn_train, bn_eval = bn_phase(dev, batch_norm)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        percep_row = percep_phase(dev, percep)
        voxel_row = voxel_phase(dev, voxel)
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
    reset_launch_counts()
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
    request_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print('inference path launches', json.dumps(request_launches),
          f'peak_device_gb {peak_gb:.2f}', flush=True)
    want = decode_launches(True, 128, *ex._dense_plan(),
                           meshes=args.requests,
                           encodes=(1,) * args.requests)
    if request_launches != want:
        fail(f'inference path launches {request_launches}, expected '
             f'{want}')

    # ---- no waits: warm encode, 128^3 and 256^3 decodes, train step ------
    no_waits = sync_phase(model, imgs[0], card_line)

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
    # train_multi over K = 2 batches: K steps' launches, finite losses
    reset_launch_counts()
    _, multi = tex.train_multi(batches[1:3])
    rec = dict(launches=launch_counts(),
               losses={k: v.tolist() for k, v in multi.items()})
    print('train_multi', json.dumps(rec), flush=True)
    want = {k: 2 * v for k, v in step_launches().items()}
    if rec['launches'] != want:
        fail(f'train_multi of 2 batches: launches {rec["launches"]}, '
             f'expected {want}')
    if not np.isfinite(list(rec['losses'].values())).all():
        fail('train_multi of 2 batches: a loss is not finite')
    del tex
    torch.cuda.empty_cache()

    # ---- --remat_save_samples 0 / 1 / 2 at the training cell --------------
    remat_levels = remat_levels_phase(args, tcfg, batches[:3], card_line)
    del batches
    torch.cuda.empty_cache()

    # ---- the overfit gate: tools/torch_overfit_chip.py, 400 steps ---------
    overfit = overfit_phase(args, stencil3d, fused_fc0, card_line)
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
    torch.cuda.empty_cache()

    # ---- training driver: stage 1 executor, then train() twice -----------
    stage1 = stage1_phase(args, stencil3d, fused_fc0)
    torch.cuda.empty_cache()
    driver = driver_phase(args, stencil3d, fused_fc0)
    driver_launches = driver['stage2']['launches']
    torch.cuda.empty_cache()

    # ---- Pix3D: raw meshes -> preprocessing -> FPS -> train() -> sweep ----
    pix3d = pix3d_phase(args, stencil3d, fused_fc0, card_line)
    pix3d_launches = pix3d['stage2_launches']
    torch.cuda.empty_cache()

    # ---- distributed phase: 2 gloo ranks, 1 NCCL rank, the split decode ---
    dist = dist_phase(args, stencil3d, fused_fc0, card_line, sweep)

    kernels = [
        dict(name='conv3x3x3', route='cuda', source=stencil3d.SOURCE,
             replaces=stencil3d.REPLACES,
             launches=request_launches['conv3x3x3'],
             per=conv['unit'], max_abs_err=conv['max_abs_err'],
             ms=conv['ms'], plain_ms=conv['plain_ms'],
             bound_ms=conv['bound_ms'], bound_by=conv['bound_by'],
             library_ms=conv['library_ms']),
        dict(name='conv3x3x3_train', route='cuda', source=stencil3d.SOURCE,
             replaces=stencil3d.REPLACES,
             launches=train_launches['conv3x3x3'],
             dx_launches=train_launches['conv3x3x3_dx'],
             driver_launches=driver_launches['conv3x3x3'],
             pix3d_launches=pix3d_launches['conv3x3x3'],
             per=conv_train['unit'], max_abs_err=conv_train['max_abs_err'],
             ms=conv_train['ms'], plain_ms=conv_train['plain_ms'],
             bound_ms=conv_train['bound_ms'],
             bound_by=conv_train['bound_by'],
             library_ms=conv_train['library_ms']),
        dict(name='conv3x3x3_dk', route='cuda', source=stencil3d.DK_SOURCE,
             replaces=stencil3d.DK_REPLACES,
             launches=train_launches['conv3x3x3_dk'],
             driver_launches=driver_launches['conv3x3x3_dk'],
             pix3d_launches=pix3d_launches['conv3x3x3_dk'], per=dk['unit'],
             max_abs_err=dk['max_abs_err'], ms=dk['ms'],
             plain_ms=dk['plain_ms'], bound_ms=dk['bound_ms'],
             bound_by=dk['bound_by'], library_ms=dk['library_ms']),
        dict(name='fused_stack_head', route='cuda', source=fused_fc0.SOURCE,
             replaces=fused_fc0.REPLACES,
             launches=request_launches['fused_stack_head'],
             driver_launches=driver_launches['fused_stack_head'],
             pix3d_launches=pix3d_launches['fused_stack_head'],
             per='request (n = 128^3)',
             max_abs_err=head['max_abs_err'], ms=head['ms'],
             plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
             bound_by=head['bound_by'], library_ms=head['library_ms']),
        dict(name='fused_fc0_mlp', route='cuda', source=fused_fc0.MLP_SOURCE,
             replaces=fused_fc0.MLP_REPLACES,
             launches=sweep['sweeps'][0]['launches']['fused_fc0_mlp'],
             staging=mlp_row['staging'], per=mlp['unit'],
             max_abs_err=mlp['max_abs_err'], ms=mlp['ms'],
             plain_ms=mlp['plain_ms'], bound_ms=mlp['bound_ms'],
             bound_by=mlp['bound_by'], library_ms=mlp['library_ms']),
        dict(name='batch_norm', route='cuda', source=batch_norm.SOURCE,
             replaces=None, library='cuDNN (F.batch_norm)',
             launches=request_launches['batch_norm'], per=bn_eval['unit'],
             max_abs_err=bn_eval['max_abs_err'], ms=bn_eval['ms'],
             plain_ms=bn_eval['plain_ms'], bound_ms=bn_eval['bound_ms'],
             bound_by=bn_eval['bound_by'],
             library_ms=bn_eval['library_ms']),
        dict(name='batch_norm_train', route='cuda', source=batch_norm.SOURCE,
             replaces=None, library='cuDNN (F.batch_norm)',
             launches=train_launches['batch_norm'],
             bwd_launches=train_launches['batch_norm_bwd'],
             driver_launches=driver_launches['batch_norm'],
             pix3d_launches=pix3d_launches['batch_norm'],
             per=bn_train['unit'], max_abs_err=bn_train['max_abs_err'],
             ms=bn_train['ms'], plain_ms=bn_train['plain_ms'],
             var_mean_ms=bn_train['var_mean_ms'],
             bound_ms=bn_train['bound_ms'], bound_by=bn_train['bound_by'],
             library_ms=bn_train['library_ms']),
        dict(name='percep_sample', route='cuda', source=percep.SOURCE,
             replaces=None, library=percep_row['library'],
             launches=request_launches['percep_sample'],
             per='slab (n = 128^3, C = 512)',
             max_abs_err=percep_row['max_abs_err'], ms=percep_row['ms'],
             plain_ms=percep_row['plain_ms'], bound_ms=percep_row['bound_ms'],
             bound_by=percep_row['bound_by'],
             library_ms=percep_row['library_ms']),
        dict(name='voxel_taps', route='cuda', source=voxel.SOURCE,
             replaces=None, library=None,
             launches=request_launches['voxel_taps'],
             per=voxel_row['unit'], max_abs_err=voxel_row['max_abs_err'],
             f64_use=voxel_row['f64_use'], ms=voxel_row['ms'],
             plain_ms=voxel_row['plain_ms'], bound_ms=voxel_row['bound_ms'],
             bound_by=voxel_row['bound_by'], library_ms=None),
    ]
    report = dict(card=card_line, kind=kind, kernels=kernels,
                  conv_inference=conv, conv_train=conv_train, dk=dk,
                  conv_gradients_on_card=grads_on_card, head=head, mlp=mlp,
                  batch_norm=dict(train=bn_train, request=bn_eval),
                  percep_sample=percep_row, voxel_taps=voxel_row,
                  requests=requests, peak_device_gb=peak_gb,
                  no_waits=no_waits,
                  small_input_err=ref_err, small_input_k4_err=k4_err,
                  sweep=sweep, train_steps=steps,
                  train_launches=train_launches, gradient_check=gcheck,
                  remat_levels=remat_levels, overfit=overfit,
                  stage1=stage1, driver=driver, pix3d=pix3d, dist=dist,
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
