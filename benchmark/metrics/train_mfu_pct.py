"""Model FLOPs of a training step (the configuration's reference module's
``train_step_flops``: 3 x the forward of every convolution and linear
layer, from the configuration's shapes) over the traced run's window step
time, as a share of the bf16 peak of the cell's cards."""

from benchmark.metrics._common import card_peaks
from benchmark.reference import models


def read(record):
    pk, step_s = card_peaks(record), record.get('train_step_s')
    if pk is None or not step_s:
        return None
    flops = models.find(record['cfg']).train_step_flops(record['cfg'])
    return (100.0 * flops / step_s / pk['bf16_flops']
            / record['cell']['chips'])
