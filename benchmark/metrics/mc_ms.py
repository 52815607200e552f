"""Marching cubes of a mesh request on the host (``generate_mesh`` in a
mesh worker, host clock), mean over the window's requests."""

from benchmark.metrics._common import mean_ms


def read(record):
    return mean_ms(r['mc_s'] for r in record.get('requests', ()))
