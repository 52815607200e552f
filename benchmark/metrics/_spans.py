"""Shared reading of the program's spans and counters
(``list_tpu_torch/utils/spans.py``).  The traced sub-window is the
program's newest recorded stretch, so its snapshot holds that window's
spans.  Every function gives None where there is nothing to read: a
program without the recorder, no span of the name, or a device time where
the spans have none (the CPU)."""

from __future__ import annotations

import collections
import importlib
from typing import Dict, List, Optional


def snapshot() -> Optional[Dict]:
    try:
        spans = importlib.import_module('list_tpu_torch.utils.spans')
    except ModuleNotFoundError:
        return None
    return spans.snapshot()


def named(snap: Optional[Dict], name: str) -> List[Dict]:
    return [s for s in (snap or {}).get('spans', ()) if s['name'] == name]


def mean_ms(name: str, key: str) -> Optional[float]:
    """The mean of ``key`` (``host_ms`` or ``device_ms``) over the spans
    named ``name``."""
    v = [s[key] for s in named(snapshot(), name) if s[key] is not None]
    return sum(v) / len(v) if v else None


def per_id_ms(name: str, key: str) -> Optional[float]:
    """The mean over ids (steps, requests) of ``key`` summed over the
    spans named ``name`` of that id."""
    by_id = collections.Counter()
    for s in named(snapshot(), name):
        if s[key] is not None:
            by_id[s['id']] += s[key]
    return sum(by_id.values()) / len(by_id) if by_id else None


def self_ms(name: str, child: str) -> Optional[float]:
    """The mean host time of the spans named ``name`` less that of their
    children named ``child``."""
    snap = snapshot()
    inner = collections.Counter()
    for s in named(snap, child):
        inner[s['parent']] += s['host_ms']
    v = [s['host_ms'] - inner[s['serial']] for s in named(snap, name)]
    return sum(v) / len(v) if v else None


def counter(name: str) -> Optional[int]:
    snap = snapshot()
    return None if snap is None else snap['counters'].get(name)
