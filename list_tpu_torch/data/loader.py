"""Host-side batching (counterpart of ``collate`` in
``list_tpu/data/loader.py``; the threaded loader is not copied)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [np.asarray(it[k]) for it in items]
        out[k] = np.stack(vals, axis=0)
    return out
