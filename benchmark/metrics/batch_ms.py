"""The batch's host work of a training step (``step.batch``: the rows
of this rank, the occupancy check and cast, the upload), host ms, mean
over the traced steps."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('step.batch', 'host_ms')
