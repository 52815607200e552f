"""The per-layer metrics read from the program's spans and counters
(``metrics/_spans.py``): each cell rehearsed with ``--trace 1`` on the CPU
states its host-clock span metrics and leaves out the device-time ones;
a program without the recorder leaves them all out."""

import importlib

import pytest

from benchmark import harness
from conftest import rehearse

B = harness.bench()
CELLS = [w['name'] for w in B['workloads']]
HOST = ('batch_ms', 'launch_ms', 'fetch_ms')
DEVICE = ('forward_ms', 'backward_ms', 'voxel_ms', 'percep_ms', 'band_ms',
          'allreduce_ms')
SPANS = [m['name'] for m in B['per_layer']
         if m['source'] in ('program_span', 'program_counter')
         and m['name'] not in ('encode_ms', 'decode_ms')] + ['allreduce_ms']


@pytest.mark.parametrize('cell', CELLS)
def test_cpu_traced_reads_host_spans_only(cell):
    line, err, _ = rehearse(cell, trace=True)
    mine = {m['name'] for m in harness.per_layer(B, cell)}
    got = line['metrics']
    for name in HOST:
        if name in mine:
            assert got[name]['value'] > 0, (name, err)
    for name in DEVICE:
        assert name not in got, name
    if 'band_fallback_pct' in mine:
        assert 0 <= got['band_fallback_pct']['value'] <= 100


@pytest.mark.parametrize('metric', SPANS)
def test_without_the_recorder_nothing_is_read(metric, monkeypatch):
    """A program that has no ``utils/spans.py`` (an older checkout): the
    reader returns None and does not raise."""
    real = importlib.import_module

    def missing(name, *a, **k):
        if name == 'list_tpu_torch.utils.spans':
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(importlib, 'import_module', missing)
    assert harness.reader(metric)({}) is None
