"""The dense decode of a mesh request on the card: the program's
CUDA-event span from the encode's end to the decode's end
(``timings['decode_s']``), mean over the window's requests."""

from benchmark.metrics._common import mean_ms


def read(record):
    return mean_ms(r['decode_s'] for r in record.get('requests', ()))
