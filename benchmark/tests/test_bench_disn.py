"""The cell ``disn.mesh128`` rehearsed on the CPU at a tiny size through
``harness.run_cell``: the configuration cut to 32^2 images, a 16^3 grid
and narrow channels (its widths are the configuration's), four renders.
The program comes out correct, the control (fp8 decoder, TF32 encoder)
and the mirrored answer (``fault_swap``) do not, and a traced run records
the decode's ``decode.percep`` and ``decode.head`` spans of every traced
request, which a card's run reads as ``percep_ms``, ``disn_head_ms`` and
``disn_head_roofline_pct``."""

import json
import os

import pytest

from benchmark import harness
from benchmark.metrics import _spans
from conftest import rehearse, tiny_root

CELL = 'disn.mesh128'
NARROW = dict(vgg_widths=[4, 8, 8, 16, 16], vgg_fc=[32, 32, 24],
              disn_point=[8, 16, 32], disn_head=[32, 16])


@pytest.fixture(scope='module', autouse=True)
def narrow():
    """The tiny root's DISN configuration with narrow channels."""
    root = tiny_root()
    b = harness.bench(root)
    conf = harness.find(b['configs'], harness.find(
        b['workloads'], CELL, 'workload')['config'], 'config')
    path = os.path.join(root, conf['file'])
    cfg = harness.load_json(path)
    cfg.update(NARROW)
    cfg['program_flags'].update(NARROW)
    with open(path, 'w') as f:
        json.dump(cfg, f)


def test_the_program_comes_out_correct():
    line, err, readings = rehearse(CELL)
    assert line['correct'], err
    assert line['attempted'] > 0 and 'setup_s' in line['metrics']
    assert set(line['checks']) == {'class_flip', 'vertex_gap'}


@pytest.mark.parametrize('mode', ['control', 'fault_swap'])
def test_the_control_and_the_mirrored_answer_come_out_not_correct(mode):
    line, err, _ = rehearse(CELL, mode=mode)
    assert not line['correct'], err


def test_a_traced_run_records_the_decode_spans():
    line, err, _ = rehearse(CELL, trace=True)
    snap = _spans.snapshot()
    for name in ('decode.percep', 'decode.head'):
        ids = {s['id'] for s in _spans.named(snap, name)}
        assert len(ids) >= 2, (name, err)
    # the CPU states no device time
    for name in ('percep_ms', 'disn_head_ms', 'disn_head_roofline_pct'):
        assert name not in line['metrics']
    assert line['metrics']['launch_ms']['value'] > 0


def test_a_traced_line_on_a_card_carries_the_head_metrics():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    line, err, _ = rehearse(CELL, trace=True, device='cuda')
    m = line['metrics']
    assert m['disn_head_ms']['value'] > 0 and m['percep_ms']['value'] > 0
    assert 0 < m['disn_head_roofline_pct']['value'] <= 100, err


test_a_traced_line_on_a_card_carries_the_head_metrics = pytest.mark.cuda(
    test_a_traced_line_on_a_card_carries_the_head_metrics)
