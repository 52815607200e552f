"""Offline evaluation CLIs (copied from ``list_tpu/eval/offline.py``;
reference: evaluation/evaluate.py,
evaluation/evaluate_gather.py — minus their hard-coded cluster paths).

``evaluate``: walk a generation directory of predicted meshes
(<gen_dir>/<cat>/<shape>/<cam>_pred.obj), evaluate each against the GT mesh
tree (<mesh_dir>/<cat>/<shape>/isosurf_scaled.obj), and write one
eval_<shape>_<cam>.pkl per shape.

``gather``: aggregate the per-shape pkls into mean/median pickles and a CSV.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from list_tpu_torch.eval.metrics import eval_mesh, eval_pointcloud
from list_tpu_torch.utils.logging import write_scores_csv
from list_tpu_torch.utils.meshio import load_mesh


def evaluate_one(pred_path: str, gt_path: str, bb_min: float, bb_max: float,
                 out_pkl: str, n_points: int = 100000) -> Dict[str, float]:
    pred = load_mesh(pred_path)
    gt = load_mesh(gt_path)
    scores = eval_mesh(pred, gt, bb_min, bb_max, n_points=n_points)
    with open(out_pkl, 'wb') as f:
        pickle.dump(scores, f)
    return scores


def _evaluate_job(job: Tuple) -> Optional[str]:
    """mp.Pool worker (module-level for pickling); returns the pkl path or
    None on failure."""
    pred_path, gt_path, bb_min, bb_max, out_pkl, n_points = job
    try:
        evaluate_one(pred_path, gt_path, bb_min, bb_max, out_pkl, n_points)
        return out_pkl
    except Exception as e:  # keep going like the reference (evaluate.py:77)
        print('eval failed for', pred_path, e)
        return None


def evaluate_main(argv=None) -> int:
    p = argparse.ArgumentParser(description='Batch mesh evaluation')
    p.add_argument('--gen_dir', required=True,
                   help='Directory of <cat>/<shape>/<cam>_pred.obj meshes')
    p.add_argument('--mesh_dir', required=True,
                   help='GT tree of <cat>/<shape>/isosurf_scaled.obj')
    p.add_argument('--out_dir', default=None)
    p.add_argument('--bb_min', type=float, default=-0.5)
    p.add_argument('--bb_max', type=float, default=0.5)
    p.add_argument('--n_points', type=int, default=100000)
    p.add_argument('--workers', type=int, default=0,
                   help='Parallel eval processes; 0 = cpu_count '
                        '(reference: evaluate.py:140-144 mp.Pool).')
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(args.gen_dir, 'eval')
    os.makedirs(out_dir, exist_ok=True)

    jobs = []
    for pred_path in sorted(glob(os.path.join(args.gen_dir, '*', '*',
                                              '*_pred.obj'))):
        parts = pred_path.split(os.sep)
        cat, shape = parts[-3], parts[-2]
        cam = os.path.basename(pred_path).split('_')[0]
        gt_path = os.path.join(args.mesh_dir, cat, shape,
                               'isosurf_scaled.obj')
        if not os.path.exists(gt_path):
            continue
        out_pkl = os.path.join(out_dir, f'eval_{cat}_{shape}_{cam}.pkl')
        if os.path.exists(out_pkl):
            continue
        jobs.append((pred_path, gt_path, args.bb_min, args.bb_max, out_pkl,
                     args.n_points))

    workers = args.workers or mp.cpu_count()
    if workers > 1 and len(jobs) > 1:
        with mp.Pool(workers) as pool:
            results = list(pool.imap_unordered(_evaluate_job, jobs))
    else:
        results = [_evaluate_job(j) for j in jobs]
    n = sum(1 for r in results if r)
    print(f'evaluated {n} meshes -> {out_dir}')
    return n


def gather_main(argv=None) -> str:
    p = argparse.ArgumentParser(description='Aggregate per-shape eval pkls')
    p.add_argument('--eval_dir', required=True)
    p.add_argument('--out_prefix', default=None)
    args = p.parse_args(argv)
    prefix = args.out_prefix or os.path.join(args.eval_dir, 'gathered')

    rows: List[Dict] = []
    for pkl_path in sorted(glob(os.path.join(args.eval_dir, 'eval_*.pkl'))):
        with open(pkl_path, 'rb') as f:
            scores = pickle.load(f)
        if not scores:
            continue
        row = {'ID': os.path.basename(pkl_path)[5:-4]}
        row.update(scores)
        rows.append(row)
    if not rows:
        print('no eval pkls found')
        return ''

    keys = sorted(k for k in rows[0] if k != 'ID')
    mean = {k: float(np.nanmean([r[k] for r in rows if k in r]))
            for k in keys}
    median = {k: float(np.nanmedian([r[k] for r in rows if k in r]))
              for k in keys}
    with open(prefix + '_mean.pkl', 'wb') as f:
        pickle.dump(mean, f)
    with open(prefix + '_median.pkl', 'wb') as f:
        pickle.dump(median, f)
    csv_path = prefix + '.csv'
    write_scores_csv(csv_path, rows, mean_row=True)
    print(f'gathered {len(rows)} evals -> {csv_path}')
    return csv_path
