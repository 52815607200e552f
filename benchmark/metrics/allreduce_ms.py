"""A data-parallel training step's exchange on rank 0's card: the
gradients' and the losses' all-reduces (``step.allreduce``, CUDA events),
ms, mean over the traced steps.  The span's time includes the wait for
the slowest rank."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('step.allreduce', 'device_ms')
