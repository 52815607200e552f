"""Full-split inference sweep (counterpart of
``list_tpu/infer/pipeline.py``; reference: test.py:14-167).

Per shape: fetch the test data, reuse a cached ``_pred.obj`` when present
(re-evaluating the saved mesh), otherwise run the dense-grid SDF decode on
the device and mesh extraction on the host; accumulate per-shape metrics
into a CSV with an appended mean row.  ``--chunk_s/--chunk_l`` select a
window of the test list.

The device decode of shape i+1 overlaps the host's marching cubes and
metrics of shape i: ``predict_grid(..., device_out=True)`` returns without
waiting for the card, a fetch pool runs up to 4 device->host grid
transfers (``fetch_grid_f32``, a band decode under ``--fetch_mode band``;
on the card each on a side stream that waits on its result's CUDA event
only) while a pool of host workers meshes and evaluates (the native
routines release the GIL), with at most 4 meshes in flight.  ``--infer_batch B`` encodes B
images per pass.  Executors without a ``predict_grid`` (CoarseNet) take
the serial per-shape path.  Under ``--multihost 1`` each process sweeps
its strided share of the window (``parallel.multihost.shard_datalist``) on
its own device, with no cross-process work inside the sweep, and writes
``<cat>_p{rank}.csv``; ``evaluation/evaluate_torch.py`` and
``evaluation/evaluate_gather_torch.py`` score and merge the processes'
meshes offline.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from list_tpu_torch import registry
from list_tpu_torch.ops.band import fetch_grid_f32
from list_tpu_torch.parallel import multihost
from list_tpu_torch.train import checkpoints as ckpt
from list_tpu_torch.train.trainer import build_executor, build_model
from list_tpu_torch.utils.logging import write_scores_csv
from list_tpu_torch.utils.meshing import generate_mesh
from list_tpu_torch.utils.meshio import load_mesh


def test_one_without_gttransmat(executor, dataset, cat_id, shape_id,
                                output_dir, cam_id, eval_pred
                                ) -> Dict[str, float]:
    """Serial per-shape path (executors without predict_grid; the
    reference's test_one_*, test.py:14-52)."""
    os.makedirs(os.path.join(output_dir, cat_id, shape_id), exist_ok=True)
    eval_score: Dict[str, float] = {}
    fname = os.path.join(output_dir, cat_id, shape_id, str(cam_id).zfill(2))
    batch = dataset.get_testdata(cat_id, shape_id, cam_id)
    if os.path.exists(fname + '_pred.obj'):
        try:
            pred = load_mesh(fname + '_pred.obj')
            if eval_pred and batch.get('gt_mesh') is not None:
                eval_score = executor.eval(pred, batch['gt_mesh'])
        except Exception:
            pred, eval_score = executor.test(batch, eval_pred)
            executor.save(batch, pred, fname)
    else:
        start = time.time()
        pred, eval_score = executor.test(batch, eval_pred)
        executor.save(batch, pred, fname)
        print('Time', time.time() - start)
    return eval_score


def _device_infer(executor, dataset, cat_id, shape_id, output_dir, cam_id):
    """Device part of one shape: (batch, fname, pred_values), pred_values
    None when a cached mesh exists (host-only re-eval)."""
    os.makedirs(os.path.join(output_dir, cat_id, shape_id), exist_ok=True)
    fname = os.path.join(output_dir, cat_id, shape_id, str(cam_id).zfill(2))
    batch = dataset.get_testdata(cat_id, shape_id, cam_id)
    if os.path.exists(fname + '_pred.obj'):
        return batch, fname, None
    # device_out: the call returns once the card has the work queued; the
    # fetch pool copies the grid to the host while the device decodes the
    # next shape
    pred_values = executor.predict_grid(batch['rgb_image'],
                                        batch.get('transmat'),
                                        device_out=True)
    return batch, fname, pred_values


def _fetch_f32(pred_values) -> np.ndarray:
    """Device->host fetch + f32 upcast (bf16 wire; band decode for
    ``--fetch_mode band``), run on the fetch pool."""
    return fetch_grid_f32(pred_values)


def _host_finish(executor, batch, fname, pred_values, eval_pred
                 ) -> Dict[str, float]:
    """Host part of one shape: marching cubes + save + eval (worker thread).
    ``pred_values`` may be a Future of the fetch pool."""
    if pred_values is None:
        try:
            pred = load_mesh(fname + '_pred.obj')
            if eval_pred and batch.get('gt_mesh') is not None:
                return executor.eval(pred, batch['gt_mesh'])
            return {}
        except Exception:
            pred_values = executor.predict_grid(batch['rgb_image'],
                                                batch.get('transmat'))
    if hasattr(pred_values, 'result'):  # fetch-pool future
        pred_values = pred_values.result()
    pred_values = np.asarray(pred_values).astype(np.float32)
    mesh = generate_mesh(pred_values, executor.bb_min, executor.bb_max,
                         as_trimesh_obj=True,
                         renorm=getattr(executor.config, 'mesh_renorm',
                                        'reference'))
    mesh.export(fname + '_pred.obj')
    if eval_pred and batch.get('gt_mesh') is not None:
        return executor.eval(mesh, batch['gt_mesh'])
    return {}


def test_all(config, device=None) -> Optional[str]:
    """Sweep the test split on ``device`` (the card unless the caller asks
    for the CPU; under ``--multihost 1`` the rank's card); returns the CSV
    path (None when nothing was evaluated)."""
    multihost.maybe_initialize(config, device=device)
    device = device or multihost.rank_device()
    rank, world = multihost.process_info()
    model = build_model(config)
    Dataset = registry.get_class(registry.resolve(config.dataset))
    testset = Dataset(config, 'test')
    test_size = len(testset.datalist)
    executor = build_executor(config, model, device=device)

    epoch = 0
    ch_fn = os.path.join(config.checkpoint_dir, config.test_checkpoint)
    fallback = os.path.join(config.checkpoint_dir, 'best_model_train.ckpt')
    if os.path.exists(ch_fn):
        epoch, best = ckpt.load_checkpoint(ch_fn, executor.model)
        print(f'pretrained model loaded at epoch: {epoch}, '
              f'best test loss: {best}')
    elif os.path.exists(fallback):
        epoch, best = ckpt.load_checkpoint(fallback, executor.model)
        print(f'pretrained model loaded at epoch: {epoch}, '
              f'best train loss: {best}')
    else:
        print('No pretrained model was loaded')
        return None

    output_dir = os.path.join(config.results_dir, f'test_{epoch}')
    os.makedirs(output_dir, exist_ok=True)

    eval_scores: Dict[str, float] = {}
    rows: List[Dict] = []
    start_idx = config.chunk_s
    chunk = test_size if (config.chunk_l == 0
                          or start_idx + config.chunk_l > test_size) \
        else config.chunk_l + 1
    datalist = multihost.shard_datalist(
        testset.datalist[start_idx:start_idx + chunk])
    chunk = len(datalist)

    overlap = hasattr(executor, 'predict_grid')
    # Host meshing/eval workers; LIST_TPU_EVAL_WORKERS overrides.
    n_eval_workers = int(os.environ.get('LIST_TPU_EVAL_WORKERS', 0)) \
        or max(1, min(4, (os.cpu_count() or 1)))
    # Each worker's native loops default to every core: split the cores
    # between the pooled shapes instead (an explicit env wins).
    if overlap and 'LIST_TPU_NATIVE_THREADS' not in os.environ:
        os.environ['LIST_TPU_NATIVE_THREADS'] = str(
            max(1, (os.cpu_count() or 1) // n_eval_workers))
    pool = ThreadPoolExecutor(max_workers=n_eval_workers) if overlap else None
    fetch_pool = ThreadPoolExecutor(max_workers=4) if overlap else None
    pipeline_depth = 4  # meshes in flight (device grid + host f32 copies)

    eval_start = time.time()
    done = 0

    def record(eval_score, cat_id, shape_id, cam_id, shape_start,
               batch_idx):
        nonlocal done
        if config.eval_pred:
            row = {'ID': f'{shape_id}_{str(cam_id).zfill(2)}'}
            row.update(eval_score)
            rows.append(row)
        for k, v in eval_score.items():
            if np.isnan(v):
                continue
            eval_scores[k] = eval_scores.get(k, 0.0) + v
        done += 1
        eta = ((time.time() - eval_start) / done) * chunk \
            - (time.time() - eval_start)
        h = int(eta // 3600)
        m = int((eta - 3600 * h) // 60)
        s = int(eta - 3600 * h - 60 * m)
        print(f'Finished: {start_idx + done}/{start_idx + chunk} || '
              f'Time: {time.time() - shape_start:0.5f} || '
              f'ETA: {h:02d}h:{m:02d}m:{s:02d}s')

    infer_batch = max(int(getattr(config, 'infer_batch', 1) or 1), 1)
    cat_id = 'all'
    if overlap and infer_batch > 1:
        # --infer_batch: one encoder pass per group of B shapes, the
        # group's uncached shapes only; host meshing/eval of the previous
        # group drains while the current one computes on the device.
        items = []
        for data in datalist:
            cam_ids = ([data['img_id'].split('.')[0]] if 'img_id' in data
                       else [config.test_cam_id])
            items.extend((data['cat_id'], data['shape_id'], c)
                         for c in cam_ids)
        pendings: List = []

        def drain():
            for fut, meta in pendings:
                record(fut.result(), *meta)
            pendings.clear()

        for g0 in range(0, len(items), infer_batch):
            group = items[g0:g0 + infer_batch]
            shape_start = time.time()
            entries = []
            uncached = []
            for cat_id, shape_id, cam_id in group:
                os.makedirs(os.path.join(output_dir, cat_id, shape_id),
                            exist_ok=True)
                fname = os.path.join(output_dir, cat_id, shape_id,
                                     str(cam_id).zfill(2))
                batch = testset.get_testdata(cat_id, shape_id, cam_id)
                meta = (cat_id, shape_id, cam_id, shape_start, g0)
                entries.append([batch, fname, meta, None])
                if not os.path.exists(fname + '_pred.obj'):
                    uncached.append(entries[-1])
            if uncached:
                imgs = np.concatenate(
                    [e[0]['rgb_image'] for e in uncached])
                tms = None
                if uncached[0][0].get('transmat') is not None:
                    tms = np.concatenate(
                        [e[0]['transmat'] for e in uncached])
                grids = executor.predict_grid_batch(imgs, tms,
                                                    device_out=True)
                for i, e in enumerate(uncached):
                    e[3] = fetch_pool.submit(_fetch_f32, grids[i])
            drain()
            for batch, fname, meta, vals in entries:
                pendings.append(
                    (pool.submit(_host_finish, executor, batch, fname,
                                 vals, config.eval_pred), meta))
        drain()
    else:
        pendings_q = deque()  # (future, *meta), up to pipeline_depth deep
        for batch_idx, data in enumerate(datalist):
            cat_id = data['cat_id']
            shape_id = data['shape_id']
            shape_start = time.time()
            cam_ids = ([data['img_id'].split('.')[0]] if 'img_id' in data
                       else [config.test_cam_id])
            for cam_id in cam_ids:
                if not overlap:
                    eval_score = test_one_without_gttransmat(
                        executor, testset, cat_id, shape_id, output_dir,
                        cam_id, config.eval_pred)
                    record(eval_score, cat_id, shape_id, cam_id, shape_start,
                           batch_idx)
                    continue
                batch, fname, vals = _device_infer(
                    executor, testset, cat_id, shape_id, output_dir, cam_id)
                if vals is not None:
                    vals = fetch_pool.submit(_fetch_f32, vals)
                while len(pendings_q) >= pipeline_depth:
                    fut, *meta = pendings_q.popleft()
                    record(fut.result(), *meta)
                pendings_q.append(
                    (pool.submit(_host_finish, executor, batch, fname, vals,
                                 config.eval_pred),
                     cat_id, shape_id, cam_id, shape_start, batch_idx))

        while pendings_q:
            fut, *meta = pendings_q.popleft()
            record(fut.result(), *meta)
    if overlap:
        pool.shutdown(wait=True)
        fetch_pool.shutdown(wait=True)

    logline = f'{config.exp_name} Test: epoch {epoch + 1:03d} '
    denom = max(config.chunk_l, 1)
    for k, v in eval_scores.items():
        logline += f'{k}: {v / denom:7.3f}, '
    print(logline)

    csv_path = None
    if config.eval_pred and rows:
        suffix = f'_p{rank}' if world > 1 else ''
        csv_path = os.path.join(output_dir, f'{cat_id}{suffix}.csv')
        write_scores_csv(csv_path, rows, mean_row=True)
    return csv_path
