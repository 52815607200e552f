"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest -q benchmark/tests

They rehearse each cell on the CPU at tiny sizes; tests marked ``cuda``
need a card and skip without one (decided inside the test).
"""

import json
import os
import shutil
import sys
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The tiny shapes of the CPU rehearsals: the model's structure at the
# smallest sizes that keep every layer (the decoder's widths stay, the
# program's fused head takes no other).
TINY = dict(img_res=32, vox_res=16, im_enc_layers=[1, 1, 1, 1, 4, 4, 4],
            point_feat=[128, 8, 3], point_degree=[2, 4], train_batch_size=4,
            sample_point_density=64, sample_distribution=[0.5, 0.5],
            sigmas=[0.01, 0.07], occupancy_points=500, reference_chunk=32,
            gt_points=50)
TINY_MESH_TRAFFIC = dict(distinct_images=4, check_window=6, check_requests=2,
                         warmup_requests=2, profile_requests=2, fit_images=2)

# A cell that drivers/train_dp.py serves and BENCHMARK.json does not list
# (its step time spreads too widely between runs; PERF.md §7): rehearsed
# under the limits proposed for it, with the metrics it would report.
DP4 = dict(name='list.train.dp4', config='list_stage2',
           traffic='train_closed_dp4', chips=4,
           why='stage-2 steps over 4 ranks, 2 rows a rank')
DP4_LIMITS = dict(loss_gap_first=0.015, grad_gap=None, grad_gap_median=0.009,
                  step_gap_median=0.1, rank_gap=0.0)
DP4_METRICS = ('train_step_s', 'setup_s', 'train_mfu_pct', 'idle_pct.train',
               'batch_ms', 'forward_ms', 'backward_ms', 'allreduce_ms')


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU; skips where torch has no '
        'CUDA device')


@pytest.fixture(scope='session', autouse=True)
def build_dir(tmp_path_factory):
    """The program's native builds go to a directory of the session."""
    d = str(tmp_path_factory.mktemp('build'))
    old = os.environ.get('LIST_TPU_TORCH_BUILD')
    os.environ['LIST_TPU_TORCH_BUILD'] = d
    yield d
    if old is None:
        os.environ.pop('LIST_TPU_TORCH_BUILD', None)
    else:
        os.environ['LIST_TPU_TORCH_BUILD'] = old


def _tiny_config(cfg):
    flags = dict(cfg['program_flags'])
    flags.update({k: v for k, v in TINY.items() if k in flags})
    return dict(cfg, **TINY, program_flags=flags)


_TINY = {}


def tiny_root() -> str:
    """A root that holds BENCHMARK.json and the cells' data files, every
    configuration and mesh traffic mix cut to the tiny shapes (made once
    a process, removed at its exit)."""
    if 'root' not in _TINY:
        from benchmark import harness
        _TINY['dir'] = tempfile.TemporaryDirectory(prefix='bench_tiny_')
        root = _TINY['dir'].name
        shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), root)
        for sub in ('configs', 'traffic', 'limits'):
            shutil.copytree(os.path.join(harness.HERE, sub),
                            os.path.join(root, 'benchmark', sub))
        for c in harness.bench(root)['configs']:
            path = os.path.join(root, c['file'])
            _write(path, _tiny_config(harness.load_json(path)))
        tdir = os.path.join(root, 'benchmark', 'traffic')
        for f in os.listdir(tdir):
            t = harness.load_json(os.path.join(tdir, f))
            if t['driver'] == 'mesh':
                _write(os.path.join(tdir, f), dict(t, **TINY_MESH_TRAFFIC))
        _add_dp4(root)
        _split_batches(root)
        _TINY['root'] = root
    return _TINY['root']


def _add_dp4(root):
    from benchmark import harness
    b = harness.bench(root)
    b['workloads'].append(DP4)
    b['per_layer'].append(dict(
        name='allreduce_ms', unit='ms', better='lower',
        source='program_span', layer='the all-reduces of a step',
        moves='train_step_s', workloads=[]))
    for m in b['end_to_end'] + b['per_layer']:
        if m['name'] in DP4_METRICS and 'workloads' in m:
            m['workloads'].append(DP4['name'])
    _write(os.path.join(root, 'BENCHMARK.json'), b)
    _write(os.path.join(root, 'benchmark', 'limits',
                        f'{DP4["name"]}.json'), DP4_LIMITS)


def _split_batches(root):
    """A cell over several ranks gets a configuration of its own in the
    tiny root, with two rows a rank, as its global batch gives them at
    its own size."""
    from benchmark import harness
    b = harness.bench(root)
    for w in b['workloads']:
        t = harness.load_json(os.path.join(root, 'benchmark', 'traffic',
                                           f'{w["traffic"]}.json'))
        if 'ranks' not in t:
            continue
        c = harness.find(b['configs'], w['config'], 'config')
        cfg = harness.load_json(os.path.join(root, c['file']))
        rows = 2 * t['ranks']
        name = f'{c["name"]}.{w["name"]}'
        c = dict(c, name=name, file=f'benchmark/configs/{name}.json')
        _write(os.path.join(root, c['file']), dict(
            cfg, train_batch_size=rows,
            program_flags=dict(cfg['program_flags'], train_batch_size=rows)))
        b['configs'].append(c)
        w['config'] = name
    _write(os.path.join(root, 'BENCHMARK.json'), b)


def _write(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f)


def rehearse(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
             trace: bool = False, mode: str = 'program', device='cpu'):
    """One run of ``cell`` at tiny sizes (on the CPU unless ``device``
    says), under its limits."""
    import torch
    from benchmark import harness
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed, seconds, trace, device, mode=mode,
                            root=tiny_root())
