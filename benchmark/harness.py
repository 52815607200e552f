"""One run of one cell: everything is found by the names in
``BENCHMARK.json``.

- the cell (``workloads``) names its configuration and its traffic mix;
- the configuration is the file its ``configs`` entry names;
- the traffic mix is ``benchmark/traffic/<traffic>.json``, and its
  ``driver`` key names the module ``benchmark/drivers/<driver>.py`` that
  runs it;
- the limits of the cell's comparison are ``benchmark/limits/<cell>.json``;
- a per-layer metric is read by ``benchmark/metrics/<metric>.py``, whose
  ``read(record)`` returns a number or None (nothing to read: the metric
  is left out of the line).

``run_cell`` returns the result line as a dict and the lines for standard
error; ``run.py`` is the command.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'list_tpu')


@dataclasses.dataclass
class Ctx:
    cell: Dict
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    mode: str
    t_start: float
    log: Callable[[str], None]


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def bench(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e['name'] == name:
            return e
    raise KeyError(f'no {what} named {name!r} in BENCHMARK.json')


def cell_files(b: Dict, name: str, root: str = ROOT) -> Dict[str, str]:
    """The files a cell resolves to: its data under ``root``, its driver
    beside this module."""
    cell = find(b['workloads'], name, 'workload')
    conf = find(b['configs'], cell['config'], 'config')
    data = os.path.join(root, os.path.basename(HERE))
    traffic = os.path.join(data, 'traffic', f'{cell["traffic"]}.json')
    driver = load_json(traffic)['driver']
    return dict(config=os.path.join(root, conf['file']), traffic=traffic,
                driver=os.path.join(HERE, 'drivers', f'{driver}.py'),
                limits=os.path.join(data, 'limits', f'{name}.json'))


def end_to_end(b: Dict, name: str) -> List[Dict]:
    return [m for m in b['end_to_end']
            if 'workloads' not in m or name in m['workloads']]


def per_layer(b: Dict, name: str) -> List[Dict]:
    moved = {m['name'] for m in end_to_end(b, name)}
    return [m for m in b['per_layer']
            if (name in m['workloads'] if 'workloads' in m
                else m['moves'] in moved)]


def reader(metric: str):
    path = os.path.join(HERE, 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location(
        f'benchmark.metrics.{metric.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(BANNED))


def device_info(dev: torch.device, chips: int, peak: int) -> Dict:
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': peak}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': chips, 'memory_peak_bytes': peak}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device='cuda', t_start: Optional[float] = None,
             mode: str = 'program', root: str = ROOT):
    """-> (result line, lines for standard error, every reading of the
    comparison).  ``root`` holds ``BENCHMARK.json`` and the cell's data
    files; ``mode`` other than ``program`` puts the control or a fault in
    the program's place (``calibrate.py``, the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    b = bench(root)
    files = cell_files(b, name, root)
    cell = find(b['workloads'], name, 'workload')
    cfg = load_json(files['config'])
    traffic = load_json(files['traffic'])
    limits = load_json(files['limits'])
    err: List[str] = []

    def log(msg: str) -> None:
        err.append(msg)
        print(f'benchmark: {msg}', file=sys.stderr, flush=True)

    dev = torch.device(device)
    spec = importlib.util.spec_from_file_location(
        f'benchmark.drivers.{traffic["driver"]}', files['driver'])
    driver = importlib.util.module_from_spec(spec)
    # under its own name, so that a driver's processes can import it
    sys.modules[spec.name] = driver
    spec.loader.exec_module(driver)
    ctx = Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=dev,
              mode=mode, t_start=t_start, log=log)
    log(f'driver starts at {time.perf_counter() - t_start:.3f} s')
    out = driver.run(ctx)
    log(f'run {time.perf_counter() - t_start:.3f} s in all; end-to-end '
        f'{out["e2e"]}')
    log(f'memory peak {out["memory_peak_bytes"]} bytes '
        '(max_memory_allocated, before the reference)')

    info = device_info(dev, cell['chips'], out['memory_peak_bytes'])
    if trace:
        metrics = {}
        for m in per_layer(b, name):
            v = reader(m['name'])(dict(out['record'], bench=b, cell=cell,
                                               kind=info['kind']))
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': out['e2e'][m['name']],
                               'unit': m['unit']}
                   for m in end_to_end(b, name) if m['name'] in out['e2e']}
    checks = {k: {'value': v, 'limit': limits[k]}
              for k, v in out['readings'].items()
              if limits.get(k) is not None}
    for k, v in out['readings'].items():
        if k not in checks:
            log(f'reading {k} {v!r} (not compared)')
    correct = bool(checks) and all(c['value'] <= c['limit']
                                   for c in checks.values())
    line = {'correct': correct, 'attempted': out['attempted'],
            'failed': out['failed'], 'metrics': metrics,
            'device': info}
    if trace:
        s = out['trace']
        if s:
            line['device'].update(busy_s=s['busy_s'], window_s=s['window_s'])
            line['breakdown'] = {'device_ops': s['device_ops'],
                                 'idle_gaps': s['idle_gaps']}
    line['checks'] = checks
    for k, c in checks.items():
        err.append(f'check {k} {c["value"]!r} limit {c["limit"]!r}')
    return line, err, out['readings']
