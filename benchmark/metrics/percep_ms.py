"""The dense decode's perceptual work of one mesh request
(``decode.percep``: the maps' projection, then per slab the pixel
projection, the 4-corner gather and the bilinear; CUDA events), ms summed
over the request's slabs, mean over the traced requests."""

from benchmark.metrics._spans import per_id_ms


def read(record):
    return per_id_ms('decode.percep', 'device_ms')
