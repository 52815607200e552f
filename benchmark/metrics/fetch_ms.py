"""A fetch worker's own time for one mesh request: ``request.fetch``
less its ``fetch.wait`` (the wait for the request's last kernel and the
copy), host ms, mean over the traced fetches."""

from benchmark.metrics._spans import self_ms


def read(record):
    return self_ms('request.fetch', 'fetch.wait')
