"""Score CSV of the test sweep (``write_scores_csv``, copied from
``list_tpu/utils/logging.py``)."""

from __future__ import annotations

import csv
import os

import numpy as np


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
