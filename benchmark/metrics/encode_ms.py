"""The encode of a mesh request on the card: the program's CUDA-event span
from the call's start to its encode's end (``timings['encode_s']``),
mean over the window's requests."""

from benchmark.metrics._common import mean_ms


def read(record):
    return mean_ms(r['encode_s'] for r in record.get('requests', ()))
