"""The launching thread's time inside ``predict_grid`` for one mesh
request (``request.launch``: encode, decode and finish queued), host ms,
mean over the traced requests."""

from benchmark.metrics._spans import mean_ms


def read(record):
    return mean_ms('request.launch', 'host_ms')
