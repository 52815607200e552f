"""The wire's encode of one mesh request on the card
(``request.finish``: the ``sdf_scale`` divide, the wire cast and
``band_encode``; CUDA events), ms, mean over the traced requests."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('request.finish', 'device_ms')
