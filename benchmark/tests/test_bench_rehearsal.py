"""Each cell's path rehearsed on the CPU at tiny sizes: the result line
has the contract's shape; a run without a card, or without the program
beside the benchmark, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, run
from conftest import rehearse

CELLS = [w['name'] for w in harness.bench()['workloads']]


def _shape(line, cell, trace):
    assert list(line)[-1] == 'checks'
    assert {'correct', 'attempted', 'failed', 'metrics',
            'device'} <= set(line)
    assert isinstance(line['correct'], bool) and line['failed'] == 0
    assert set(line['device']) >= {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    b = harness.bench()
    allowed = {m['name'] for m in (harness.per_layer(b, cell) if trace
                                   else harness.end_to_end(b, cell))}
    assert set(line['metrics']) <= allowed
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'}
    for c in line['checks'].values():
        assert set(c) == {'value', 'limit'}
    json.dumps(line)


@pytest.mark.parametrize('cell', CELLS)
def test_cpu_rehearsal_prints_a_line_of_the_contract(cell):
    line, err, readings = rehearse(cell)
    _shape(line, cell, False)
    assert 'setup_s' in line['metrics'] and line['attempted'] > 0
    assert line['correct'], err
    assert err[-1].startswith('check ')


@pytest.mark.parametrize('cell', CELLS)
def test_cpu_rehearsal_traced(cell):
    line, err, _ = rehearse(cell, trace=True)
    _shape(line, cell, True)
    # a CPU run states no device time: host-clock times and a counter
    for name in line['metrics']:
        assert name in ('encode_ms', 'decode_ms', 'mc_ms', 'batch_ms',
                        'launch_ms', 'fetch_ms', 'band_fallback_pct'), name


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    from benchmark import program
    for k in program.cache_dirs(harness.ROOT):
        monkeypatch.setenv(k, os.environ.get(k, ''))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'list.train', '--seed', '1', '--seconds',
                   '1', '--trace', '0'])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ''


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/."""
    shutil.copytree(os.path.join(harness.ROOT, 'benchmark'),
                    tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    script = ('import sys; sys.path.insert(0, sys.argv[1])\n'
              'from benchmark import harness\n'
              'harness.run_cell("coarsenet.train", 1, 1, False, "cpu")\n')
    r = subprocess.run([sys.executable, '-c', script, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ''
    assert 'list_tpu_torch' in r.stderr


def test_run_on_the_card():
    """On a card: one short run of the cheapest cell through the command."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    r = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'coarsenet.train', '--seed', '2147483649',
                        '--seconds', '2', '--trace', '0'],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    _shape(line, 'coarsenet.train', False)
    assert line['correct'] and line['device']['platform'] == 'gpu'


test_run_on_the_card = pytest.mark.cuda(test_run_on_the_card)
