#!/usr/bin/env python3
"""K4 (``fused_fc0_mlp``) against an earlier version of its source, on one
NVIDIA GPU, at the kernel phase's production inputs of ``chip_smoke.py``
(n = 1,048,576, t-major stacks of channels 1, 16, 32, 64):

    git show <commit>:list_tpu_torch/csrc/fused_fc0_mlp.cu > build/k4_old.cu
    python3 tools/torch_k4_probe.py --old build/k4_old.cu [--out f.json]

Builds five variants into ``build/k4_probe/`` with the package's nvcc
flags, one nvcc each, all at once: the current source, the old one, each
of them with the head replaced by a read of the staged tile (the staging
alone), and the current one with the staging removed (the head alone,
over an unset tile; the staging is the code from the kernel's
``// ROWS:`` comment to its ``// head_from_staged`` one).  Prints whether
the current and the old kernel give the same outputs bit for bit, and
CUDA-event median times of each variant in turns (old, new, new, old,
...).  The old source must take the arguments
of the current C entry point, or the same without the trailing
``staging`` array.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from list_tpu_torch.ops.cuda import build, fused_fc0  # noqa: E402

CSRC = os.path.join(ROOT, 'list_tpu_torch', 'csrc')
OUT_DIR = os.path.join(ROOT, 'build', 'k4_probe')
HEAD_CALL = re.compile(r'head_from_staged<0>\([^;]*\);')
# the staging alone: wait for the copies, then read the tile so that
# nothing staged is dead
READ_TILE = '''cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < TM && row0 + (int)threadIdx.x < n) {
    float acc = 0.f;
    for (int c = (int)threadIdx.x % 7; c < ktot; c += 53)
      acc += __bfloat162float(a_s[threadIdx.x * lda + c]);
    out[row0 + threadIdx.x] = acc;
  }'''
STAGING_BEGIN = '  // ROWS: 16-byte cp.async'
STAGING_END = "  // head_from_staged's first wait"


def variants(new_src: str, old_src: str) -> dict:
    for name, src in (('new', new_src), ('old', old_src)):
        if len(HEAD_CALL.findall(src)) != 1:
            raise SystemExit(f'{name}: expected one head_from_staged call')
    a, b = new_src.index(STAGING_BEGIN), new_src.index(STAGING_END)
    return {'new': new_src, 'old': old_src,
            'new_stage': HEAD_CALL.sub(READ_TILE, new_src),
            'old_stage': HEAD_CALL.sub(READ_TILE, old_src),
            'head_only': new_src[:a] + new_src[b:]}


def build_variants(srcs: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(OUT_DIR, f'{name}.cu')
        with open(path, 'w') as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, '-I', CSRC, '-o',
             os.path.join(OUT_DIR, f'lib{name}.so'), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f'nvcc failed for {name}:\n{log}')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'ptxas {name}: {line.strip()}', flush=True)


def launcher(name: str, inputs: dict, n: int, dev):
    """A zero-argument launch of variant ``name`` on the inputs, into an
    output of its own; the C entry point's ``staging`` array is passed
    when the source has one."""
    lib = ctypes.CDLL(os.path.join(OUT_DIR, f'lib{name}.so'))
    src = open(os.path.join(OUT_DIR, f'{name}.cu')).read()
    staged = 'int* staging' in src
    fn = lib.fused_fc0_mlp_bf16
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * (11 if staged else 10))
    fn.restype = ctypes.c_int
    stacks, chs = inputs['stacks'], inputs['channels']
    ptrs = (ctypes.c_void_p * len(stacks))(*[t.data_ptr() for t in stacks])
    cs = (ctypes.c_int * len(stacks))(*chs)
    paths = (ctypes.c_int * len(stacks))()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    w = inputs['weights']
    tail = [w[k].data_ptr() for k in ('wxyz', 'b1', 'w2', 'b2', 'w3', 'b3',
                                      'w4', 'b4')]

    def call():
        rc = fn(ptrs, cs, len(stacks), n, inputs['percep'].data_ptr(),
                inputs['q'].data_ptr(), 3, w['w1cat'].data_ptr(),
                w['w1cat'].shape[0], *tail, out.data_ptr(),
                *([paths] if staged else []), build.stream_handle(dev))
        if rc:
            raise SystemExit(f'{name}: launch failed (code {rc})')
        return out
    return call, paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--old', required=True,
                    help='an earlier list_tpu_torch/csrc/fused_fc0_mlp.cu')
    ap.add_argument('--out', default=None, help='also write the JSON here')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs an NVIDIA GPU')
    with open(os.path.join(CSRC, 'fused_fc0_mlp.cu')) as f:
        new_src = f.read()
    with open(args.old) as f:
        old_src = f.read()
    build_variants(variants(new_src, old_src))

    dev = torch.device('cuda')
    res = dict(card=chip_smoke.card())
    print(res['card'], flush=True)
    n = 64 * 128 ** 2
    chs = chip_smoke.MLP_CHANNELS
    # the kernel phase's inputs (chip_smoke.mlp_phase)
    u = chip_smoke._uniform(torch.Generator(device=dev).manual_seed(15), dev)
    bf = torch.bfloat16
    stacks = [u(7, n, c, dt=bf).abs() for c in chs]
    w1 = [u(7 * c, 512, scale=1 / np.sqrt(3610), dt=bf) for c in chs]
    percep = u(n, 512, scale=0.5, dt=bf)
    q = u(n, 3)
    tail = chip_smoke._head_tail(u, bf)
    w1cat, wxyz, (b1, b2, b3, b4), (w2, w3), w4 = fused_fc0._prep_weights(
        [7 * c for c in chs], w1, *tail, dev)
    inputs = dict(stacks=stacks, channels=chs, percep=percep, q=q,
                  weights=dict(w1cat=w1cat, wxyz=wxyz, b1=b1, w2=w2, b2=b2,
                               w3=w3, b3=b3, w4=w4, b4=b4))
    calls = {k: launcher(k, inputs, n, dev)
             for k in ('new', 'old', 'new_stage', 'old_stage', 'head_only')}
    y_new = calls['new'][0]().clone()
    y_old = calls['old'][0]().clone()
    torch.cuda.synchronize()
    res['staging_new'] = [fused_fc0.STAGING_PATHS[p]
                          for p in calls['new'][1]]
    res['bit_identical'] = bool(torch.equal(y_new, y_old))
    res['max_abs_diff'] = float((y_new - y_old).abs().max())
    ref = fused_fc0.fused_fc0_mlp_plain(stacks, percep, q, w1, *tail)
    res['new_max_abs_err_vs_plain'] = float((y_new - ref).abs().max())
    del ref
    order = ('old', 'new', 'new', 'old', 'old_stage', 'new_stage',
             'head_only', 'head_only', 'new_stage', 'old_stage', 'old', 'new')
    res['ms'] = {k: [] for k in calls}
    for k in order:
        res['ms'][k].append(chip_smoke.time_ms(calls[k][0], args.reps))
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)


if __name__ == '__main__':
    main()
