"""Reduction of a ``torch.profiler`` trace of a steady sub-window.

The sub-window is marked by a ``record_function`` span named ``WINDOW``;
device operations are clipped to it.  From it: the card's busy seconds
(the union of its kernel, copy and set intervals; the device timeline's
copies of host annotations left out) and the window's length; the device
time of each kernel name and its count;
the device operations that took the most time; and the longest idle
gaps, each named by the shortest host operation that covers its middle
(what the host was doing while the card waited).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch

WINDOW = 'benchmark.subwindow'
TOP = 10


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def _union(iv: List[Tuple[float, float]]):
    merged = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> Dict:
    """{'busy_s', 'window_s', 'kernel_s': {name: s}, 'kernel_n': {name: n},
    'device_ops': [[name, s]], 'idle_gaps': [[name, s]]}; empty when the
    trace holds no device operation."""
    dev, host, win = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((s, t, e.name, bool(getattr(e, 'is_user_annotation',
                                                    False))))
        elif e.name == WINDOW:
            win = (s, t)
        else:
            host.append((s, t, e.name))
    # the device-side copies of host annotations (record_function spans,
    # the optimizer's step) are no device work
    names = {n for _, _, n in host} | {WINDOW}
    dev = [(s, t, n) for s, t, n, a in dev if not a and n not in names]
    if not dev or win is None:
        return {}
    lo, hi = win
    dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev
           if t > lo and s < hi]
    if not dev:
        return {}
    busy = _union([(s, t) for s, t, _ in dev])
    kernel_s = collections.Counter()
    kernel_n = collections.Counter()
    for s, t, n in dev:
        kernel_s[n] += (t - s) / 1e6
        kernel_n[n] += 1
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (s + t) / 2
        cover = [(ht - hs, n) for hs, ht, n in host if hs <= mid <= ht]
        named.append([min(cover)[1] if cover else 'no host op',
                      (t - s) / 1e6])
    return dict(busy_s=sum(t - s for s, t in busy) / 1e6,
                window_s=(hi - lo) / 1e6, kernel_s=dict(kernel_s),
                kernel_n=dict(kernel_n),
                device_ops=[[n, v] for n, v in kernel_s.most_common(TOP)],
                idle_gaps=named)


def kernel_time(summary: Dict, needle: str) -> Tuple[float, int]:
    """Summed device seconds and count of the kernels whose name holds
    ``needle``."""
    ks = summary.get('kernel_s', {})
    kn = summary.get('kernel_n', {})
    hit = [n for n in ks if needle in n]
    return sum(ks[n] for n in hit), sum(kn[n] for n in hit)
