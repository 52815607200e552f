"""The share of band fetches that overflowed the band and fetched the
full grid: 100 x ``band.fallbacks`` / ``band.fetches`` (the program's
counters) over the traced sub-window."""

from benchmark.metrics._spans import counter


def read(record):
    n = counter('band.fetches')
    return 100.0 * (counter('band.fallbacks') or 0) / n if n else None
