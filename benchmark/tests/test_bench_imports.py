"""Import guard: nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole), and the reference loads nothing
of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, 'benchmark')
REFERENCE = ['benchmark.reference.model', 'benchmark.reference.weights',
             'benchmark.reference.models',
             'benchmark.reference.models.LIST',
             'benchmark.reference.models.CoarseNet',
             'benchmark.check', 'benchmark.counts', 'benchmark.peaks',
             'benchmark.traffic_gen', 'benchmark.trace']


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


def test_no_source_of_the_benchmark_imports_jax():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith('.py'):
                names = _top_level_imports(os.path.join(d, f))
                assert not names & set(harness.BANNED), (f, names)


def test_reference_and_yardstick_import_nothing_of_the_program():
    for mod in REFERENCE:
        path = os.path.join(harness.ROOT, *mod.split('.'))
        path = (path + '.py' if os.path.isfile(path + '.py')
                else os.path.join(path, '__init__.py'))
        assert 'list_tpu_torch' not in _top_level_imports(path), mod
    code = ('import sys; sys.path.insert(0, sys.argv[1])\n'
            + ''.join(f'import {m}\n' for m in REFERENCE)
            + 'tops = {m.split(".")[0] for m in sys.modules}\n'
            'assert "list_tpu_torch" not in tops, sorted(tops)\n'
            'assert not tops & {"jax", "jaxlib", "flax", "optax", '
            '"list_tpu"}, sorted(tops)\n')
    r = subprocess.run([sys.executable, '-c', code, harness.ROOT],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_a_run_loads_no_jax():
    """A whole CPU rehearsal in a fresh process, then the guard."""
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'sys.path.insert(0, sys.argv[2])\n'
            'from conftest import rehearse\n'
            'rehearse("coarsenet.train")\n'
            'from benchmark import harness\n'
            'assert harness.banned_modules() == [], harness.banned_modules()\n'
            'tops = {m.split(".")[0] for m in sys.modules}\n'
            'assert "list_tpu_torch" in tops\n')
    env = dict(os.environ)
    env.setdefault('LIST_TPU_TORCH_BUILD', os.path.join(
        harness.ROOT, 'build', 'list_tpu_torch'))
    r = subprocess.run([sys.executable, '-c', code, harness.ROOT,
                        os.path.dirname(os.path.abspath(__file__))],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]


def test_the_guard_sees_a_banned_module(monkeypatch):
    monkeypatch.setitem(sys.modules, 'list_tpu', object())
    assert harness.banned_modules() == ['list_tpu']
    monkeypatch.delitem(sys.modules, 'list_tpu')
    monkeypatch.setitem(sys.modules, 'list_tpu_torch_x', object())
    assert 'list_tpu' not in harness.banned_modules()
