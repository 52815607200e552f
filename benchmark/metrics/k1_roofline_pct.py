"""K1, the dense decode's fused head: its launches times the least time of
the head's work at resolution^3 queries (``counts.k1_bound_s``) over its
device time, from the profiled sub-window."""

from benchmark import counts, program, trace
from benchmark.metrics._common import card_peaks


def read(record):
    pk = card_peaks(record)
    t, n = trace.kernel_time(record.get('trace', {}), program.KERNELS['k1'])
    if pk is None or n == 0 or t <= 0:
        return None
    return 100.0 * n * counts.k1_bound_s(
        record['cfg'], record['resolution'] ** 3, pk) / t
