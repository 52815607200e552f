#!/usr/bin/env python3
"""The benchmark of ``list_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for (a run that finds fewer exits 2 and prints no result).
The cell, its configuration, traffic, limits and per-layer metrics are
found by the names in ``BENCHMARK.json`` (``benchmark/harness.py``).
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled sub-window after the window.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared and their limits.  A run
that finds ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``list_tpu`` among
its loaded modules once the window has closed exits 3 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness, program, peaks
    os.environ.update(program.cache_dirs(ROOT))
    import torch

    b = harness.bench()
    chips = harness.find(b['workloads'], args.workload, 'workload')['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'benchmark: {args.workload} needs {chips} CUDA card(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count() {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    print(f'benchmark: card ready at {time.perf_counter() - T_START:.3f} s',
          file=sys.stderr, flush=True)
    line, _, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), 'cuda', T_START)
    bad = harness.banned_modules()
    if bad:
        print(f'benchmark: loaded modules that the port may not load: {bad}',
              file=sys.stderr)
        return 3
    print(f'benchmark: card {peaks.card_line()}', file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    for k, c in line['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr, flush=True)
    return 0


if __name__ == '__main__':
    faulthandler.enable()
    sys.exit(main())
