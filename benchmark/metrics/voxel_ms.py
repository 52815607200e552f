"""The dense decode's voxel-feature work of one mesh request
(``decode.voxel``: z/y variants, coarse term, the x-lerps that build the
head's parts; CUDA events), ms summed over the request's slabs, mean over
the traced requests."""

from benchmark.metrics._spans import per_id_ms


def read(record):
    return per_id_ms('decode.voxel', 'device_ms')
