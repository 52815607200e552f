"""Overfit and reconstruction gate of the PyTorch/CUDA port at the
production configuration (the port's twin of ``tools/overfit_chip.py``).

Trains the default full-width LIST (two ResNet18s at 224^2, the TreeGCN
to 4,096 points, vox_res 128, bf16 feature packing, the K2/K3 stencil
kernels) on ONE analytic sphere of radius 0.35: batch 4 x 32,768 queries a
step drawn from a pool of 2^18 points (half near the surface, sigma 0.03,
half uniform in the box) with exact sphere SDF values, the occupancy at
vox_res 128, ``sdf_scale`` 10, lr 1e-3, no decode remat, 2 query chunks
and 4 steps a ``train_multi`` dispatch, as the JAX tool does.  Then it
runs the production inference path: ``predict_grid`` (dense 128^3 decode
through K1, bf16 wire, band fetch), marching cubes with the exact
renormalization, and the containment IoU against the sphere on 200,000
uniform points (``implicit_waterproofing``).

    python tools/torch_overfit_chip.py [--steps 400] [--seed 0] \
        [--device cuda]

Prints the loss curve every 40 steps with the mean ``step_s`` since the
last line, then a RESULT line, and exits non-zero unless the gate holds:
every loss finite, the final ``sdf_loss`` below half of the first step's,
a mesh of more than 10 vertices and IoU > 0.7 (the JAX tool's gate).
``main`` runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

RADIUS = 0.35
BATCH, QUERIES, POOL = 4, 32768, 1 << 18
EVAL_POINTS = 200000
IOU_GATE = 0.7


def overfit_config(steps_per_dispatch: int = 4):
    from list_tpu_torch.config import default_config
    return default_config(sdf_scale=10.0, vox_res=128,
                          train_batch_size=BATCH,
                          sample_point_density=QUERIES,
                          sample_distribution=[1.0], remat_decode=0,
                          train_query_chunks=2, lr=1e-3,
                          steps_per_dispatch=steps_per_dispatch)


def sphere_data(rng, res: int):
    """The disc image (1, 224, 224, 3), the query pool and its exact SDF,
    and the (BATCH, res, res, res) occupancy of the sphere."""
    from list_tpu_torch.data.synthetic import sphere_sdf
    u = np.linspace(-0.6, 0.6, 224)
    px, py = np.meshgrid(u, u, indexing='xy')
    disc = (px ** 2 + py ** 2 < RADIUS ** 2).astype(np.float32)
    image = np.stack([disc] * 3, -1)[None]
    dirs = rng.standard_normal((POOL // 2, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    near = dirs * (RADIUS + 0.03 * rng.standard_normal((POOL // 2, 1)))
    unif = rng.uniform(-0.5, 0.5, (POOL // 2, 3))
    pool = np.concatenate([near, unif]).astype(np.float32)
    sdf = sphere_sdf(pool, (0, 0, 0), RADIUS).astype(np.float32)
    x = (np.arange(res) + 0.5) / res - 0.5
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    occ = np.broadcast_to(
        (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) < RADIUS).astype(np.float32),
        (BATCH, res, res, res)).copy()
    return image, pool, sdf, occ


def main(device='cuda', steps: int = 400, seed: int = 0,
         log=print) -> dict:
    """Train ``steps`` steps on ``device`` from weights seeded by ``seed``,
    mesh the result and score it -> the run's record (``passed`` says
    whether the gate holds)."""
    from list_tpu_torch.eval.metrics import implicit_waterproofing
    from list_tpu_torch.data.synthetic import sphere_sdf
    from list_tpu_torch.models import LIST
    from list_tpu_torch.train import LISTExecutor
    from list_tpu_torch.utils.meshing import generate_mesh

    cfg = overfit_config()
    k = cfg.steps_per_dispatch
    torch.manual_seed(seed)
    ex = LISTExecutor(cfg, LIST.from_config(cfg), device=device)
    ex.init_optimizer()
    on_card = ex.device.type == 'cuda'
    rng = np.random.default_rng(seed)
    image, pool, pool_sdf, occ = sphere_data(rng, cfg.vox_res)
    images = np.repeat(image, BATCH, axis=0)

    def make_batch():
        idx = rng.integers(0, POOL, (BATCH, QUERIES))
        return {'rgb_image': images, 'points': pool[idx],
                'values': pool_sdf[idx], 'occ': occ}

    log(f'device={ex.device} steps={steps} lr={cfg.lr} k={k} seed={seed}')
    if on_card:
        torch.cuda.reset_peak_memory_stats(ex.device)
    losses, step_s, curve = [], [], []
    t_train = time.perf_counter()
    while len(losses) < steps:
        n = k if k > 1 and steps - len(losses) >= k else 1
        batches = [make_batch() for _ in range(n)]
        t0 = time.perf_counter()
        if n > 1:
            _, out = ex.train_multi(batches)
            host = {key: v.cpu().numpy() for key, v in out.items()}
            losses += [{key: float(v[i]) for key, v in host.items()}
                       for i in range(n)]
        else:
            losses.append({key: float(v)
                           for key, v in ex.train(batches[0])[1].items()})
        step_s += [(time.perf_counter() - t0) / n] * n
        done = len(losses)
        if done <= k or done % 40 == 0 or done >= steps:
            last = losses[-1]
            since = step_s[(curve[-1]['step'] if curve else 0):]
            curve.append(dict(step=done, sdf_loss=last['sdf_loss'],
                              occ_loss=last['occ_loss'],
                              step_s=float(np.mean(since))))
            log(f'step {done:4d}: sdf_loss {last["sdf_loss"]:.4f} occ_loss '
                f'{last["occ_loss"]:.4f} step_s {curve[-1]["step_s"]:.4f} '
                f'({time.perf_counter() - t_train:.1f} s)')
    train_s = time.perf_counter() - t_train
    peak_gb = (torch.cuda.max_memory_allocated(ex.device) / 1e9
               if on_card else None)

    # the production inference path: dense decode, band fetch, MC, IoU
    t0 = time.perf_counter()
    grid = ex.predict_grid(image)
    mesh = generate_mesh(grid, cfg.bb_min, cfg.bb_max, as_trimesh_obj=True,
                         renorm='exact')
    pts = rng.uniform(-0.5, 0.5, (EVAL_POINTS, 3))
    gt_in = sphere_sdf(pts, (0, 0, 0), RADIUS) < 0
    iou = 0.0
    if len(mesh.vertices) > 10:
        pred_in = implicit_waterproofing(mesh, pts)[0].astype(bool)
        iou = float(np.logical_and(gt_in, pred_in).sum()
                    / max(np.logical_or(gt_in, pred_in).sum(), 1))
    gates = dict(
        finite=all(np.isfinite(v) for d in losses for v in d.values()),
        sdf_loss_halved=losses[-1]['sdf_loss'] < 0.5 * losses[0]['sdf_loss'],
        vertices=len(mesh.vertices) > 10, iou=iou > IOU_GATE)
    rec = dict(device=str(ex.device), steps=steps, seed=seed,
               first_losses=losses[0], last_losses=losses[-1], curve=curve,
               step_s_median=float(np.median(step_s)), train_s=train_s,
               peak_device_gb=peak_gb, encode_s=ex.timings['encode_s'],
               decode_s=ex.timings['decode_s'],
               mesh_eval_s=time.perf_counter() - t0,
               vertices=len(mesh.vertices), faces=len(mesh.faces), iou=iou,
               gates=gates, passed=all(gates.values()))
    log(f'mesh: {rec["vertices"]} vertices, {rec["faces"]} faces')
    log(f'RESULT iou={iou:.4f} steps={steps} sdf_loss '
        f'{losses[0]["sdf_loss"]:.4f} -> {losses[-1]["sdf_loss"]:.4f} '
        f'occ_loss {losses[0]["occ_loss"]:.4f} -> '
        f'{losses[-1]["occ_loss"]:.4f} step_s median '
        f'{rec["step_s_median"]:.4f}')
    log(('GATE PASS' if rec['passed'] else 'GATE FAIL')
        + f' (finite losses, sdf_loss halved, > 10 vertices, iou > '
        f'{IOU_GATE}): {gates}')
    return rec


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=400)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    result = main(args.device, args.steps, args.seed,
                  log=lambda s: print(s, flush=True))
    sys.exit(0 if result['passed'] else 1)
