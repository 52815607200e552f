"""A training step's forward and losses on the card (``step.forward``,
CUDA events), ms, mean over the traced steps."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('step.forward', 'device_ms')
