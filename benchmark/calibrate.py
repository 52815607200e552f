#!/usr/bin/env python3
"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> \
        --seeds 11 12 13 ... [--seconds 0] [--out readings.jsonl]

Each seed runs the cell as ``run.py`` does with ``--seconds`` (0: no
window; a mesh cell still answers its sampled requests) and prints one
JSON line: the seed, the mode, ``correct`` under the cell's limits and
every reading of the comparison.
``program`` gives the lower readings, ``control`` (the reference in the
next lower precision in the program's place) and the faults the upper
ones (``benchmark/README.md``).  The benchmark's own runs never run this.
"""

import time

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--mode', default='program')
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=0.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)

    from benchmark import harness, program
    os.environ.update(program.cache_dirs(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        line, _, readings = harness.run_cell(args.workload, seed,
                                             args.seconds, False, 'cuda', t,
                                             args.mode)
        rec = dict(workload=args.workload, mode=args.mode, seed=seed,
                   seconds=time.perf_counter() - t, correct=line['correct'],
                   readings={k: float(v) for k, v in readings.items()})
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
