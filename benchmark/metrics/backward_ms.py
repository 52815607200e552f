"""A training step's backward on the card, the ``--remat`` recompute
included (``step.backward``, CUDA events), ms, mean over the traced
steps."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('step.backward', 'device_ms')
