"""Experiment observability (copied from ``list_tpu/utils/logging.py``):
scalar logging (TensorBoard-compatible + CSV/JSONL), append-only text log,
the sweep's score CSV, and the reference's command/source-snapshot
bookkeeping (reference: train.py:111-113,238-239,295-296,313-323;
utils.py:13-17).
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import sys
import time
from datetime import datetime

import numpy as np


def print_log(log_fname: str, logline: str) -> None:
    os.makedirs(os.path.dirname(log_fname) or '.', exist_ok=True)
    with open(log_fname, 'a') as f:
        f.write(logline + '\n')


class SummaryWriter:
    """Scalar writer: JSONL always; TensorBoard event files when the optional
    ``tensorboard`` package is importable (same add_scalar/add_text API)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, 'scalars.jsonl'), 'a')
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TB
            self._tb = TB(logdir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {'tag': tag, 'value': float(value), 'step': int(step),
             'ts': time.time()}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._jsonl.write(json.dumps(
            {'tag': tag, 'text': text, 'step': int(step)}) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def write_scores_csv(path: str, rows, mean_row: bool = True) -> None:
    """Per-shape score rows + appended mean row (reference:
    test.py:127-162)."""
    if not rows:
        return
    keys = ['ID'] + sorted(k for k in rows[0] if k != 'ID')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow([''] + keys)
        for i, r in enumerate(rows):
            w.writerow([i] + [round(r.get(k, float('nan')), 5)
                              if k != 'ID' else r.get(k, '') for k in keys])
        if mean_row:
            means = {}
            for k in keys:
                if k == 'ID':
                    continue
                vals = [r[k] for r in rows
                        if k in r and not np.isnan(r[k])]
                means[k] = float(np.mean(vals)) if vals else float('nan')
            w.writerow([len(rows)] + ['Mean' if k == 'ID'
                                      else round(means[k], 5) for k in keys])


def snapshot_experiment(config) -> None:
    """Append the command line and snapshot the source tree into
    ``results/<exp>/code`` (reference: train.py:313-323, rsync equivalent)."""
    code_dir = os.path.join(config.results_dir, 'code')
    os.makedirs(code_dir, exist_ok=True)
    with open(os.path.join(code_dir, 'command.txt'), 'a+') as fp:
        ctxt = ' '.join(sys.argv)
        fp.write(f'{datetime.now():%m/%d/%Y %H:%M:%S} --> {ctxt}\n')
    src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(code_dir, 'list_tpu_torch')
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst,
                    ignore=shutil.ignore_patterns('__pycache__', '*.so',
                                                  '*.pyc', 'build'))


class Timer:
    """Per-batch / per-shape timing + ETA meter (reference:
    train.py:89-104, test.py:141-147)."""

    def __init__(self, total: int):
        self.total = total
        self.start = time.time()

    def eta(self, done: int) -> str:
        if done == 0:
            return '--:--'
        elapsed = time.time() - self.start
        eta = elapsed / done * self.total - elapsed
        h = int(eta // 3600)
        m = int((eta - 3600 * h) // 60)
        s = int(eta - 3600 * h - 60 * m)
        return f'{h:02d}h:{m:02d}m:{s:02d}s' if h else f'{m:02d}m:{s:02d}s'
