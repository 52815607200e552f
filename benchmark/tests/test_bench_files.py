"""BENCHMARK.json against the contract's shape, and every name in it
resolved to its file; a new cell and metric need new files only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
B = harness.bench()


def test_top_level_keys_and_paths():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert B['paths'] == ['benchmark']
    assert B['command'] == ['python3', 'benchmark/run.py']
    assert isinstance(B['run_seconds'], int) and 1 <= B['run_seconds'] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in B['workloads']])
def test_cell_resolves_to_its_files(cell):
    files = harness.cell_files(B, cell)
    for path in files.values():
        assert os.path.isfile(path), path
    limits = harness.load_json(files['limits'])
    assert any(v is not None for v in limits.values())
    assert harness.end_to_end(B, cell) and harness.per_layer(B, cell)
    assert 'setup_s' in {m['name'] for m in harness.end_to_end(B, cell)}


@pytest.mark.parametrize('metric', [m['name'] for m in B['per_layer']])
def test_metric_resolves_to_its_reader(metric):
    assert callable(harness.reader(metric))


def test_names_units_and_bounds():
    seen = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in B[group]:
            assert NAME.match(e['name']) and e['name'] not in seen
            seen.add(e['name'])
    for c in B['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/') and c['reduced'] == []
    for w in B['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
    for m in B['end_to_end'] + B['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in B['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    moved = {m['name'] for m in B['end_to_end']}
    for m in B['per_layer']:
        assert m['moves'] in moved and '\n' not in m['layer']


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a traffic mix, a cell and a per-layer metric
    by new files and BENCHMARK.json entries, and resolve them there."""
    shutil.copytree(os.path.join(ROOT, 'benchmark'),
                    tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = json.loads(json.dumps(B))
    b['workloads'].append({'name': 'list.train.dummy', 'config': 'list_stage2',
                           'traffic': 'dummy_mix', 'chips': 1,
                           'why': 'a test cell'})
    b['per_layer'].append({'name': 'dummy_ms', 'unit': 'ms',
                           'better': 'lower', 'source': 'host_clock',
                           'layer': 'a test layer', 'moves': 'train_step_s',
                           'workloads': ['list.train.dummy']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    (tmp_path / 'benchmark' / 'traffic' / 'dummy_mix.json').write_text(
        json.dumps({'driver': 'train', 'distinct_batches': 2,
                    'checked_steps': 2, 'profile_steps': 1}))
    (tmp_path / 'benchmark' / 'limits' / 'list.train.dummy.json').write_text(
        json.dumps({'grad_gap': 0.1}))
    (tmp_path / 'benchmark' / 'metrics' / 'dummy_ms.py').write_text(
        'def read(record):\n    return 1.0\n')
    script = ('import sys; sys.path.insert(0, sys.argv[1])\n'
              'from benchmark import harness\n'
              'b = harness.bench()\n'
              'f = harness.cell_files(b, "list.train.dummy")\n'
              'import os; assert all(os.path.isfile(p) for p in f.values())\n'
              'names = [m["name"] for m in harness.per_layer(b, '
              '"list.train.dummy")]\n'
              'assert names == ["dummy_ms"], names\n'
              'assert harness.reader("dummy_ms")({}) == 1.0\n'
              'print("resolved")\n')
    before = {p: open(p, 'rb').read() for p in _files(ROOT)}
    r = subprocess.run([sys.executable, '-c', script, str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and 'resolved' in r.stdout, r.stderr
    assert before == {p: open(p, 'rb').read() for p in _files(ROOT)}


def _files(root):
    out = [os.path.join(root, 'BENCHMARK.json')]
    for d, _, fs in os.walk(os.path.join(root, 'benchmark')):
        out += [os.path.join(d, f) for f in fs if f.endswith(('.py', '.json'))
                and '__pycache__' not in d]
    return sorted(out)
