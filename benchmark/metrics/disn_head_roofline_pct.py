"""DISN's dense-decode head against its roofline: the traced requests
times the least time of the head's work at resolution^3 queries (the
reference module's ``head_bound_s``) over the ``decode.head`` spans'
device time, summed over the profiled sub-window.  It reads the same
work whatever implements the head."""

from benchmark.metrics import _spans
from benchmark.metrics._common import card_peaks
from benchmark.reference import models


def read(record):
    pk = card_peaks(record)
    spans = [s for s in _spans.named(_spans.snapshot(), 'decode.head')
             if s['device_ms'] is not None]
    if pk is None or not spans:
        return None
    t = sum(s['device_ms'] for s in spans) / 1e3
    ids = len({s['id'] for s in spans})
    cfg = record['cfg']
    mod = models.find(cfg)
    if t <= 0 or not hasattr(mod, 'head_bound_s'):
        return None
    return 100.0 * ids * mod.head_bound_s(
        cfg, record['resolution'] ** 3, pk) / t
