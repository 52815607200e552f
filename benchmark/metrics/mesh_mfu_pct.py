"""Model FLOPs of a mesh (the configuration's reference module's
``mesh_flops``: the encoder and the decoder MLP over every grid query,
from the configuration's shapes) times the traced run's meshes a second,
as a share of the card's bf16 peak."""

from benchmark.metrics._common import card_peaks
from benchmark.reference import models


def read(record):
    pk, rate = card_peaks(record), record.get('meshes_per_s')
    if pk is None or not rate:
        return None
    cfg = record['cfg']
    return 100.0 * models.find(cfg).mesh_flops(cfg, record['resolution']) \
        * rate / pk['bf16_flops']
