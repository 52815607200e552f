"""K2 (forward and input gradient) and K3 (weight gradient), the voxel
encoder's full-resolution 3x3x3 convolutions in a training step: the
summed least times of a step's calls (``counts.stencil_step_bound_s``)
times the profiled steps, over the kernels' device time."""

from benchmark import counts, program, trace
from benchmark.metrics._common import card_peaks


def read(record):
    pk, s = card_peaks(record), record.get('trace', {})
    parts = [trace.kernel_time(s, program.KERNELS[k])
             for k in ('k2', 'k3_partial', 'k3_reduce')]
    t, n = sum(p[0] for p in parts), sum(p[1] for p in parts)
    if pk is None or n == 0 or t <= 0:
        return None
    return 100.0 * record['profile_steps'] * counts.stencil_step_bound_s(
        record['cfg'], pk) / t
