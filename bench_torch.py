#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (list_tpu_torch) on one NVIDIA GPU:
the counterpart of the JAX package's ``bench.py``.

    python3 bench_torch.py [--device cuda] [--seed 0] [--report out.json]

Run from the repository root.  It measures the port's main paths at full
width (ResNet18s at 224^2, TreeGCN to 4,096 points, ``h_dim`` 256) with
weights from ``torch.manual_seed(seed)`` and inputs from
``np.random.RandomState(seed)``, drawn in ``bench.py``'s order:

1. Train step: the reference recipe (batch 8 x 32,768 queries at 128^3,
   ``--remat 1``, 4 query chunks, ``--remat_save_samples 1``), 1 warm and
   5 timed ``LISTExecutor.train`` steps (host clock around a synchronized
   step: ``train_step_s`` is their median), then ``train_multi`` over
   K = 2 batches; the launches of every step asserted.
2. Headline: 3 trials of 16 ``predict_grid(img, device_out=True)`` 128^3
   meshes (band fetch, bf16 wire), each fetched by a 5-worker pool of
   ``fetch_grid_f32``; the grid wire, the synchronized call and the
   batched sweep (``predict_grid_batch`` of 4 images) beside it.  Before
   timing, ``fc_out``'s bias is shifted so that the first grid's median is
   zero: random weights then give a surface, and the band carries what a
   trained model's would.
3. Stage breakdown: encode, the dense decode with the executor's own plan,
   the f32 and band fetches, the band's host decode; the decoder's
   FLOP/s against the card's bf16 peak.
4. The 256^3 decode from the 128^3 features (the executor's plan at
   R = 256), band-encoded in bf16 and fetched in the pool.
5. The chunked anchor: 65,536-point chunks of the grid through the gather
   decoder (``LIST.decode_sdf``, what ``_chunked_decode`` runs).
6. Host evaluation: marching cubes and ``eval_mesh`` of a phantom sphere
   grid against an icosphere.

A phase that fails raises.  The last line printed is one JSON object,
``{"metric": "sdf_queries_per_sec", "value": ..., "unit": "queries/s",
"extras": {...}}``, with ``bench.py``'s key names where a key measures
the same thing; ``--report`` writes it to a file too.  Every result names
its device; on the CPU (``--device cpu``) each key of ``DEVICE_ONLY`` is
"not measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np
import torch

from list_tpu_torch import native
from list_tpu_torch.config import default_config
from list_tpu_torch.device import card, peak_rates, resolve_device, time_ms
from list_tpu_torch.eval.metrics import eval_mesh
from list_tpu_torch.models import LIST
from list_tpu_torch.models.list_model import (DEFAULT_IM_ENC_LAYERS,
                                              vox_channels)
from list_tpu_torch.ops.band import (BandGrid, band_decode, band_encode,
                                     band_to_numpy, fetch_grid_f32)
from list_tpu_torch.ops.cuda import (batch_norm, launch_counts,
                                     reset_launch_counts)
from list_tpu_torch.ops.dense_grid import dense_grid_sdf
from list_tpu_torch.ops.grid import create_grid_points_from_bounds
from list_tpu_torch.train import LISTExecutor
from list_tpu_torch.utils.meshing import generate_mesh
from list_tpu_torch.utils.meshio import make_icosphere

# decoder MLP FLOPs per query (bench.py's constant: Conv1d 3610-512-256-
# 256-1 of the reference)
FLOP_PER_QUERY = 2 * (3610 * 512 + 512 * 256 + 256 * 256 + 256)
# ResNet18s at 224^2, the perceptual resizes and the heads, per item and
# forward (bench.py's estimate)
OTHER_FWD_FLOP = 5e9
FETCH_WORKERS = 5
TRAIN_MULTI_K = 2
NOT_MEASURED = 'not measured'
# Keys that only a run on the card measures: "not measured" on the CPU.
DEVICE_ONLY = ('card', 'peak_bf16_tflops', 'hbm_tbs', 'train_eff_tflops',
               'train_mfu_pct', 'train_hbm_bound_s', 'train_peak_gb',
               'infer_peak_gb', 'encode_s_device', 'decode_s_device',
               'wire_mbps', 'decode_eff_tflops', 'decode_mfu_pct',
               'sec_per_mesh_128_device', 'qps_device')


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What one run does; ``PRODUCTION`` is the benchmark, the tests run a
    tiny one on the CPU."""
    vox_res: int           # the grid of the headline and of the encoder
    r_hi: int              # the fine grid decoded from vox_res features
    img_res: int
    train_batch: int
    train_queries: int
    train_steps: int       # timed, after one warm step
    train_multi_calls: int  # timed train_multi calls of K batches
    trials: int            # headline trials
    meshes: int            # meshes a headline trial
    grid_meshes: int       # meshes over the grid wire
    serial: int            # synchronized predict_grid calls
    batch_images: int      # images a predict_grid_batch
    batch_reps: int
    reps: int              # repeats of a stage time (median)
    hi_reps: int           # synchronized decodes at r_hi (median)
    hi_meshes: int         # pipelined meshes at r_hi
    chunk: int             # --test_pointnum: the chunked anchor's chunk
    anchor_chunks: int
    eval_points: int       # eval_mesh's surface points (10x for the IoU)
    model: Sequence = ()   # (flag, value) pairs of the model's widths


PRODUCTION = Sizes(vox_res=128, r_hi=256, img_res=224, train_batch=8,
                   train_queries=32768, train_steps=5, train_multi_calls=2,
                   trials=3, meshes=16, grid_meshes=8, serial=3,
                   batch_images=4, batch_reps=2, reps=5, hi_reps=3,
                   hi_meshes=4, chunk=65536, anchor_chunks=4,
                   eval_points=100000)


# ---- counts (shapes only; bench.py:219-238) ----------------------------------

def decoder_flop_per_query(in_dim: int = 3610, h_dim: int = 256) -> int:
    """FLOPs of the SDF decoder's in_dim-2h-h-h-1 MLP a query."""
    return 2 * (in_dim * 2 * h_dim + 2 * h_dim * h_dim + h_dim * h_dim
                + h_dim)


def vox_conv_flops(layers: Sequence[int] = DEFAULT_IM_ENC_LAYERS,
                   vox_res: int = 128) -> float:
    """Forward FLOPs of VoxelEncoder2's 3x3x3 convolutions for one item:
    one conv a layer, a second one and a 2x pooling from layer 3 on."""
    flops, R = 0.0, vox_res
    for li in range(len(layers) - 1):
        flops += 2 * R ** 3 * 27 * layers[li] * layers[li + 1]
        if li >= 3:
            flops += 2 * R ** 3 * 27 * layers[li + 1] ** 2
            R //= 2
    return flops


def train_model_tflop(batch: int, n_queries: int = 32768,
                      vox_res: int = 128,
                      layers: Sequence[int] = DEFAULT_IM_ENC_LAYERS,
                      flop_per_query: int = FLOP_PER_QUERY) -> float:
    """Matrix and conv TFLOP of one train step: the decoder over the
    queries, the voxel encoder and ``OTHER_FWD_FLOP`` an item, forward and
    backward (3x the forward)."""
    fwd = n_queries * flop_per_query + vox_conv_flops(layers, vox_res) \
        + OTHER_FWD_FLOP
    return 3 * batch * fwd / 1e12


def train_gather_gb(batch: int, n_queries: int = 32768,
                    layers: Sequence[int] = DEFAULT_IM_ENC_LAYERS) -> float:
    """GB the multi-scale sampler gathers in one step: 7 displacements x
    8 corners x the summed channels (bf16) a query forward, and the
    backward's scatter-add twice that."""
    ch = sum(vox_channels(layers))
    return 3 * batch * n_queries * 7 * 8 * ch * 2 / 1e9


# ---- launch counts, from the code -------------------------------------------

def full_res_convs(layers: Sequence[int] = DEFAULT_IM_ENC_LAYERS) -> int:
    """K2 calls of one VoxelEncoder2 forward: every convolution before its
    first pooling (conv_0, conv_1, conv_2, then conv_3 and conv_3_0)."""
    n = len(layers) - 1
    return min(n, 3) + (2 if n > 3 else 0)


def routed_norms(layers: Sequence[int], batch: int, R: int) -> list:
    """The channels of each VoxelEncoder2 BatchNorm that ``routes`` sends
    to the kernels at ``batch`` and vox_res R: bn_0 and bn_1 at R^3, then
    bn_l (l > 2) at (R / 2^(l - 3))^3."""
    return [layers[l + 1] for l in range(len(layers) - 1) if l != 2
            and batch_norm.routes(5, torch.float32, layers[l + 1],
                                  batch * (R >> max(0, l - 3)) ** 3)]


def launches(on_card: bool, k2: int = 0, dx: int = 0, dk: int = 0,
             k1: int = 0, k4: int = 0, bn: int = 0, bn_bwd: int = 0,
             percep: int = 0) -> Dict[str, int]:
    """The launch counts a path must give: these on the card, none on the
    CPU (the wrappers take their plain versions there)."""
    n = dict(conv3x3x3=k2, conv3x3x3_dx=dx, conv3x3x3_dk=dk,
             fused_stack_head=k1, fused_fc0_mlp=k4, batch_norm=bn,
             batch_norm_bwd=bn_bwd, percep_sample=percep)
    return n if on_card else {k: 0 for k in n}


def step_launches(on_card: bool, layers: Sequence[int], remat: bool,
                  batch: int, R: int) -> Dict[str, int]:
    """One LISTExecutor.train step: the encoder's full-resolution convs
    forward (again under remat), dx of each but conv_0 (its input is the
    occupancy grid) and dk of each; the routed BatchNorms' backward, and
    the forward (again under remat) of those the kernels normalize."""
    n = full_res_convs(layers)
    norms = routed_norms(layers, batch, R)
    fwd = sum(batch_norm.normalizes(c) for c in norms)
    return launches(on_card, k2=n * (2 if remat else 1) + n - 1, dx=n - 1,
                    dk=n, bn=fwd * (2 if remat else 1), bn_bwd=len(norms))


def decode_launches(on_card: bool, R: int, slab: int, head: int,
                    k2: int = 0, bn: int = 0) -> Dict[str, int]:
    """A dense R^3 decode in slabs of ``slab`` with head ``head`` (1: K4,
    2: K1, 0: the plain head) and one perceptual sample a slab, beside
    ``k2`` encoder convolutions and ``bn`` eval BatchNorms."""
    per = R // slab
    return launches(on_card, k2=k2, k1=per if head == 2 else 0,
                    k4=per if head == 1 else 0, bn=bn, percep=per)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f'bench_torch: {msg}')


def check_launches(got: Dict[str, int], want: Dict[str, int], what: str
                   ) -> None:
    check(got == want, f'{what}: launches {got}, expected {want}')


def log(msg: str) -> None:
    print(f'bench_torch: {msg}', file=sys.stderr, flush=True)


# ---- the phases ---------------------------------------------------------------

def train_phase(dev, seed: int, s: Sizes, rng, x: dict) -> None:
    """The train step at the reference recipe (module docstring, 1)."""
    on_card = dev.type == 'cuda'
    cfg = default_config(sdf_scale=10.0, vox_res=s.vox_res,
                         train_batch_size=s.train_batch,
                         sample_point_density=s.train_queries,
                         sample_distribution=[1.0], remat_decode=-1,
                         train_query_chunks=4, fuse_sample_gathers=1,
                         remat_save_samples=1, **dict(s.model))
    b, nq, R = s.train_batch, s.train_queries, s.vox_res
    batch = {
        'rgb_image': rng.rand(b, s.img_res, s.img_res, 3).astype(np.float32),
        'points': rng.uniform(-0.5, 0.5, (b, nq, 3)).astype(np.float32),
        'values': (rng.randn(b, nq) * 0.05).astype(np.float32),
        'occ': (rng.rand(b, R, R, R) > 0.99).astype(np.float32),
    }
    torch.manual_seed(seed)
    ex = LISTExecutor(cfg, LIST.from_config(cfg), device=dev)
    layers = tuple(cfg.im_enc_layers)
    per_step = step_launches(on_card, layers, bool(cfg.remat), b, R)

    t0 = time.perf_counter()
    ex.train(batch)
    x['train_first_step_s'] = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(s.train_steps):
        reset_launch_counts()
        t0 = time.perf_counter()
        _, losses = ex.train(batch)
        steps.append(time.perf_counter() - t0)
        check_launches(launch_counts(), per_step, f'train step {i}')
    losses = {k: float(v) for k, v in losses.items()}
    check(all(np.isfinite(v) for v in losses.values()),
          f'non-finite train losses: {losses}')
    if on_card:
        x['train_peak_gb'] = torch.cuda.max_memory_allocated(dev) / 1e9

    k_steps = []
    for i in range(s.train_multi_calls):
        reset_launch_counts()
        t0 = time.perf_counter()
        _, ml = ex.train_multi([batch] * TRAIN_MULTI_K)
        k_steps.append((time.perf_counter() - t0) / TRAIN_MULTI_K)
        check_launches(launch_counts(), {k: v * TRAIN_MULTI_K for k, v
                                         in per_step.items()},
                       f'train_multi call {i}')
        check(bool(torch.isfinite(ml['sdf_loss']).all()),
              'non-finite train_multi losses')

    step_s = statistics.median(steps)
    tflop = train_model_tflop(b, nq, R, layers, decoder_flop_per_query(
        ex.model.sdf_decoder.fc_0.in_features, ex.model.h_dim))
    gb = train_gather_gb(b, nq, layers)
    x.update(train_losses=losses, train_batch=b, train_step_s=step_s,
             train_step_s_all=steps,
             train_step_s_k2=statistics.median(k_steps),
             train_steps_per_sec=1.0 / step_s, train_qps=b * nq / step_s,
             train_model_tflop=tflop, train_gather_gb=gb,
             train_launches=per_step)
    if on_card:
        eff = tflop / step_s
        x.update(train_eff_tflops=eff,
                 train_mfu_pct=100.0 * eff / x['peak_bf16_tflops'],
                 train_hbm_bound_s=gb / (x['hbm_tbs'] * 1e3))


def _shift_to_surface(ex, img) -> float:
    """Shift fc_out's bias so that the grid of ``img`` has its median at
    zero; returns the shift (raw SDF units)."""
    shift = float(np.median(ex.predict_grid(img, fetch_mode='grid'))) \
        * ex.sdf_scale
    with torch.no_grad():
        ex.model.sdf_decoder.fc_out.bias -= shift
    return -shift


def _check_grids(grids, R: int, what: str) -> None:
    check(all(g.shape == (R, R, R) and np.isfinite(g).all() for g in grids),
          f'{what}: a grid is not finite or not of shape {(R,) * 3}')


def mesh_phase(ex, dev, s: Sizes, rng, pool, x: dict):
    """The pipelined headline, the grid wire, the synchronized call and
    the batched sweep at vox_res (module docstring, 2); returns the
    headline's queries/s and its image."""
    on_card = dev.type == 'cuda'
    R = s.vox_res
    img = rng.rand(1, s.img_res, s.img_res, 3).astype(np.float32)
    slab, head = ex._dense_plan()
    convs = full_res_convs(ex.model.im_enc_layers)
    per_mesh = decode_launches(
        on_card, R, slab, head, k2=convs,
        bn=len(routed_norms(ex.model.im_enc_layers, 1, R)))

    t0 = time.perf_counter()
    x['fc_out_bias_shift'] = _shift_to_surface(ex, img)
    x['first_mesh_s'] = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    trials = []
    for t in range(s.trials):
        reset_launch_counts()
        t0 = time.perf_counter()
        futs = [pool.submit(fetch_grid_f32,
                            ex.predict_grid(img, device_out=True))
                for _ in range(s.meshes)]
        grids = [f.result() for f in futs]
        trials.append((time.perf_counter() - t0) / s.meshes)
        _check_grids(grids, R, f'headline trial {t}')
        check_launches(launch_counts(), {k: v * s.meshes for k, v
                                         in per_mesh.items()},
                       f'headline trial {t}')
        del grids
    if on_card:
        x['infer_peak_gb'] = torch.cuda.max_memory_allocated(dev) / 1e9
    sec_per_mesh = statistics.median(trials)

    t0 = time.perf_counter()
    futs = [pool.submit(fetch_grid_f32, ex.predict_grid(
        img, device_out=True, fetch_mode='grid'))
        for _ in range(s.grid_meshes)]
    grids = [f.result() for f in futs]
    x['sec_per_mesh_128_gridwire'] = (time.perf_counter() - t0) \
        / s.grid_meshes
    _check_grids(grids, R, 'grid wire')
    del grids

    serial = []
    for _ in range(s.serial):
        t0 = time.perf_counter()
        g = ex.predict_grid(img)
        serial.append(time.perf_counter() - t0)
    _check_grids([g], R, 'synchronized predict_grid')

    imgs = rng.rand(s.batch_images, s.img_res, s.img_res, 3).astype(
        np.float32)
    for g in ex.predict_grid_batch(imgs, device_out=True):
        fetch_grid_f32(g)
    reset_launch_counts()
    t0 = time.perf_counter()
    futs = [pool.submit(fetch_grid_f32, g) for _ in range(s.batch_reps)
            for g in ex.predict_grid_batch(imgs, device_out=True)]
    grids = [f.result() for f in futs]
    x['sec_per_mesh_128_batched4'] = (time.perf_counter() - t0) / (
        s.batch_reps * s.batch_images)
    _check_grids(grids, R, 'batched sweep')
    n = s.batch_reps * s.batch_images
    one = decode_launches(on_card, R, slab, head)
    check_launches(launch_counts(), launches(
        on_card, k2=s.batch_reps * convs, k1=one['fused_stack_head'] * n,
        k4=one['fused_fc0_mlp'] * n, bn=s.batch_reps * len(routed_norms(
            ex.model.im_enc_layers, s.batch_images, R)),
        percep=one['percep_sample'] * n), 'batched sweep')
    del grids

    x.update(n_queries=R ** 3, fetch_mode=ex.config.fetch_mode,
             sec_per_mesh_128=sec_per_mesh,
             sec_per_mesh_128_trials=trials,
             sec_per_mesh_128_serial=statistics.median(serial),
             decode_plan=dict(slab=slab, use_pallas=head),
             mesh_launches=per_mesh)
    return R ** 3 / sec_per_mesh, img


def _median_s(fn, reps: int, dev) -> float:
    """Median host-clock seconds of ``fn`` synchronized, after one warm
    call."""
    fn()
    ts = []
    for _ in range(reps):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


@torch.inference_mode()
def breakdown_phase(ex, dev, s: Sizes, img, x: dict):
    """Encode, decode and the fetches at vox_res (module docstring, 3);
    returns the encoding and the decode's arguments."""
    on_card = dev.type == 'cuda'
    R = s.vox_res
    model = ex.model
    img_t = torch.as_tensor(img, device=dev)
    x['encode_s'] = _median_s(lambda: model.encode(img_t), s.reps, dev)
    enc = model.encode(img_t)
    slab, head = ex._dense_plan()
    dargs = (model.sdf_decoder, enc['vox_feat'], enc['feat_l2'],
             enc['trans_mat'])
    dkw = dict(compute_dtype=ex.compute_dtype, bb_min=ex.bb_min,
               bb_max=ex.bb_max)

    def decode():
        return dense_grid_sdf(*dargs, R, slab=slab, use_pallas=head, **dkw)

    decode_s = _median_s(decode, s.reps, dev)
    if on_card:
        enc_dev = time_ms(lambda: model.encode(img_t), s.reps) / 1e3
        dec_dev = time_ms(decode, s.reps) / 1e3
        dev_s = enc_dev + dec_dev
        eff = R ** 3 * decoder_flop_per_query(
            model.sdf_decoder.fc_0.in_features, model.h_dim) / decode_s / 1e12
        x.update(encode_s_device=enc_dev, decode_s_device=dec_dev,
                 decode_eff_tflops=eff,
                 decode_mfu_pct=100.0 * eff / x['peak_bf16_tflops'],
                 sec_per_mesh_128_device=dev_s, qps_device=R ** 3 / dev_s)

    # fetch: fresh f32 grids each rep
    gs = [decode() + float(i) for i in range(s.reps)]
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for g in gs:
        fetch_grid_f32(g)
    fetch_s = (time.perf_counter() - t0) / len(gs)
    del gs
    x['fetch_s'] = fetch_s
    if on_card:
        x['wire_mbps'] = R ** 3 * 4 / 1e6 / fetch_s

    bg = ex.predict_grid(img, device_out=True)
    check(isinstance(bg, BandGrid), f'fetch_mode {ex.config.fetch_mode}: '
          'the headline fetches the band')
    x['band_wire_kb'] = bg.band.numel() * 4 / 1e3
    bufs = [bg.band + i for i in range(s.serial)]
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for b in bufs:
        band_to_numpy(b)
    x['band_fetch_s'] = (time.perf_counter() - t0) / len(bufs)
    host = band_to_numpy(bg.band, bg.ready)
    t0 = time.perf_counter()
    rec = band_decode(host, R, bg.wire_dtype)
    x.update(band_host_decode_s=time.perf_counter() - t0, decode_s=decode_s,
             band_overflow_128=int(rec is None))
    return enc, dargs, dkw


def _fetch_hi(bg: BandGrid):
    """(f32 host grid, whether the band overflowed) of a fine-grid
    result; an overflowed band is fetched as the whole wire grid."""
    buf = band_to_numpy(bg.band, bg.ready)
    rec = band_decode(buf, bg.resolution, bg.wire_dtype)
    if rec is None:
        return bg.to_numpy(), True
    return rec, False


@torch.inference_mode()
def hi_phase(ex, dev, s: Sizes, dargs, dkw, pool, x: dict) -> float:
    """The r_hi^3 decode from the vox_res encoding with the executor's plan
    at r_hi (module docstring, 4); returns its pipelined queries/s."""
    on_card = dev.type == 'cuda'
    R = s.r_hi
    slab, head = ex._dense_plan(vox_res=R)

    def decode():
        return dense_grid_sdf(*dargs, R, slab=slab, use_pallas=head, **dkw)

    want = decode_launches(on_card, R, slab, head)
    reset_launch_counts()
    x['decode_s_256'] = _median_s(decode, s.hi_reps, dev)
    check_launches(launch_counts(), {k: v * (s.hi_reps + 1) for k, v
                                     in want.items()},
                   f'{s.hi_reps + 1} decodes at {R}^3')
    if head != 0:
        # the plan's head against the plain head (use_pallas 0: the same
        # parts through fused_stack_head_plain), within chip_smoke.py's
        # kernel tolerance |head - plain| <= 1e-2 + 1e-2 |plain|
        got = decode()
        plain = dense_grid_sdf(*dargs, R, slab=slab, use_pallas=0, **dkw)
        err = (got - plain).abs()
        x['max_abs_err_256'] = float(err.max())
        check(bool((err <= 1e-2 + 1e-2 * plain.abs()).all()),
              f'{R}^3 decode: head {head} is {x["max_abs_err_256"]:.3g} off '
              'the plain head')
        del got, plain, err

    def submit():
        wire = (decode() / ex.sdf_scale).to(torch.bfloat16)
        bg = BandGrid(band_encode(wire), wire, R, 'bfloat16')
        if on_card:
            bg.ready = torch.cuda.Event()
            bg.ready.record()
        return pool.submit(_fetch_hi, bg)

    t0 = time.perf_counter()
    futs = [submit() for _ in range(s.hi_meshes)]
    out = [f.result() for f in futs]
    sec = (time.perf_counter() - t0) / s.hi_meshes
    _check_grids([g for g, _ in out], R, f'{R}^3 meshes')
    x.update(sec_per_mesh_256=sec, qps_256=R ** 3 / sec,
             band_overflow_256=sum(o for _, o in out),
             launches_256=want,
             decode_plan_256=dict(slab=slab, use_pallas=head))
    return R ** 3 / sec


@torch.inference_mode()
def anchor_phase(ex, dev, s: Sizes, enc, x: dict) -> float:
    """The first chunks of the grid through the gather decoder (module
    docstring, 5); returns its queries/s."""
    pts = create_grid_points_from_bounds(ex.bb_min, ex.bb_max, s.vox_res)
    pts = torch.as_tensor(pts.astype(np.float32)[None], device=dev)
    chunks = [pts[:, i * s.chunk:(i + 1) * s.chunk]
              for i in range(s.anchor_chunks)]

    def decode(c):
        v = ex.model.decode_sdf(c, enc)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        return v

    decode(chunks[0])
    reset_launch_counts()
    t0 = time.perf_counter()
    for c in chunks:
        decode(c)
    dt = time.perf_counter() - t0
    check_launches(launch_counts(), launches(False), 'chunked anchor')
    n = sum(int(c.shape[1]) for c in chunks)
    x['chunked_launches'] = launches(False)
    return n / dt


def eval_phase(seed: int, s: Sizes, bb_min: float, bb_max: float,
               x: dict) -> None:
    """Marching cubes and eval_mesh of a phantom sphere's grid (module
    docstring, 6)."""
    native.have_native()  # the g++ build is not timed
    np.random.seed(seed)
    gt = make_icosphere(subdivisions=4, radius=0.4)
    ax = np.linspace(bb_min, bb_max, s.vox_res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    phantom = np.sqrt(X * X + Y * Y + Z * Z) - 0.38
    t0 = time.perf_counter()
    pred = generate_mesh(phantom, bb_min, bb_max, as_trimesh_obj=True)
    mc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = eval_mesh(pred, gt, bb_min, bb_max, n_points=s.eval_points)
    ev_s = time.perf_counter() - t0
    check(np.isfinite(scores.get('iou', np.nan)),
          f'host evaluation of the phantom sphere: {scores}')
    x.update(eval_s_per_shape=mc_s + ev_s, eval_mc_s=mc_s,
             eval_iou=scores['iou'])


def run(device='cuda', seed: int = 0, sizes: Sizes = PRODUCTION) -> dict:
    """Every phase on ``device`` (``cuda`` unless the caller asks for the
    CPU; no card raises) -> the result line."""
    dev = resolve_device(device)
    on_card = dev.type == 'cuda'
    s = sizes
    t_start = time.perf_counter()
    x = dict(seed=seed)
    if on_card:
        name = torch.cuda.get_device_name(dev)
        rates = peak_rates(name)
        x.update(device=name, device_count=torch.cuda.device_count(),
                 card=card(), peak_bf16_tflops=rates['bf16_tflops'],
                 hbm_tbs=rates['mem_gbs'] / 1e3)
        log(x['card'])
    else:
        x.update(device='cpu', device_count=0)
        x.update({k: NOT_MEASURED for k in DEVICE_ONLY})
    rng = np.random.RandomState(seed)

    train_phase(dev, seed, s, rng, x)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f'train {time.perf_counter() - t_start:.1f} s')

    cfg = default_config(sdf_scale=10.0, test_pointnum=s.chunk,
                         vox_res=s.vox_res, **dict(s.model))
    torch.manual_seed(seed)
    ex = LISTExecutor(cfg, LIST.from_config(cfg), device=dev)
    with ThreadPoolExecutor(max_workers=FETCH_WORKERS) as pool:
        pool.submit(lambda: None).result()
        qps, img = mesh_phase(ex, dev, s, rng, pool, x)
        log(f'meshes {time.perf_counter() - t_start:.1f} s')
        enc, dargs, dkw = breakdown_phase(ex, dev, s, img, x)
        log(f'breakdown {time.perf_counter() - t_start:.1f} s')
        qps_hi = hi_phase(ex, dev, s, dargs, dkw, pool, x)
        log(f'{s.r_hi}^3 {time.perf_counter() - t_start:.1f} s')
    chunked = anchor_phase(ex, dev, s, enc, x)
    x.update(chunked_qps_measured=chunked,
             speedup_vs_chunked_on_chip=qps / chunked,
             speedup_256_vs_chunked=qps_hi / chunked)
    del ex, enc, dargs
    eval_phase(seed, s, cfg.bb_min, cfg.bb_max, x)
    missing = [k for k in DEVICE_ONLY if k not in x]
    check(not missing, f'device keys not measured: {missing}')
    x['total_s'] = time.perf_counter() - t_start
    return {'metric': 'sdf_queries_per_sec', 'value': qps,
            'unit': 'queries/s', 'extras': x}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain path)")
    ap.add_argument('--seed', type=int, default=0,
                    help='seeds the weights and the inputs')
    ap.add_argument('--report', default=None,
                    help='also write the result line to this JSON file')
    args = ap.parse_args(argv)
    line = run(args.device, args.seed, PRODUCTION)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line), flush=True)


if __name__ == '__main__':
    main()
