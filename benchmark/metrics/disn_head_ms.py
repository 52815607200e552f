"""DISN's dense-decode head of one mesh request (``decode.head``: the
global bias, then per slab the point MLPs, both streams' products and the
sum; CUDA events), ms summed over the request's slabs, mean over the
traced requests."""

from benchmark.metrics._spans import per_id_ms


def read(record):
    return per_id_ms('decode.head', 'device_ms')
