#!/usr/bin/env python3
"""Where the port's encode, dense decode and stage-2 train step wait on the
host, on one NVIDIA GPU:

    python3 tools/torch_decode_probe.py [--root DIR] [--label L] [--out f.json]

For the full-width default LIST (seeded random weights, one seeded 224x224
image): ``dense_grid_sdf`` through ``LISTExecutor._decode`` at 128^3 and
256^3 (from the 128^3 encoding) and ``LIST.encode``, each after one warm
call: the median host-clock seconds between synchronizations and the
median CUDA-event seconds; the host arrays converted to tensors in one call
(``numpy_uploads``); and every synchronizing call of one call, by the line
that made it (``sync_sites``, ``torch.cuda.set_sync_debug_mode('warn')``).
The card's idle share of a mesh is the benchmark's ``idle_pct.mesh``
(``benchmark/``).  Then the train step at the reference recipe (batch 8 x
32,768 queries, 128^3, remat, ``--remat_save_samples 1``, 4 query chunks;
a seeded random batch): 1 warm and 3 timed steps (``step_s``), and the
synchronizing calls of one more.

``--root`` imports ``list_tpu_torch`` from another tree (an earlier commit
unpacked with ``git archive`` into a git-ignored directory), so that two
versions are measured in one call on one card, in turns:

    python3 tools/torch_decode_probe.py --root build/parent --label parent

``sync_sites``, ``waits_allowed`` and ``numpy_uploads`` also serve
``chip_smoke.py`` and the card tests; this module imports no part of the
port at import time.
"""

import argparse
import collections
import contextlib
import json
import linecache
import os
import sys
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def sync_sites(mode: str = 'warn'):
    """Run the body under ``torch.cuda.set_sync_debug_mode(mode)`` and
    yield a Counter of its synchronizing calls (under 'warn'), keyed by
    the innermost frame of the port beside the innermost frame of all;
    'error' makes the first one raise instead.  The mode is off again
    afterwards."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        # not the notice set_sync_debug_mode itself gives on first use
        if 'called a synchronizing CUDA operation' not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if 'list_tpu_torch' in f.filename
               or f.filename.endswith('chip_smoke.py')]
        where = (f'{os.path.relpath(own[-1].filename, ROOT)}:'
                 f'{own[-1].lineno} {own[-1].name}' if own else '?')
        if not own:  # a frame of torch: name it and its source line
            where = ' < '.join(f'{f.filename}:{f.lineno} {f.name}'
                               for f in stack[-4:])
        sites[f'{where} <- {filename}:{lineno} '
              f'{linecache.getline(filename, lineno).strip()}'] += 1

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(0)


def waits_allowed(fn):
    """``fn`` with the sync debug mode off while it runs (a train step's
    batch upload and closing synchronization, say)."""
    def call(*a, **kw):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return call


@contextlib.contextmanager
def numpy_uploads():
    """Yield a list that gets (device, host seconds) for each host array
    made a tensor in the body: ``torch.as_tensor`` and ``torch.tensor`` of
    anything but a tensor that lands on a card or comes from a numpy array,
    and every ``torch.from_numpy`` (whose tensor a later ``.to`` would
    upload)."""
    seen = []
    real = dict(as_tensor=torch.as_tensor, tensor=torch.tensor,
                from_numpy=torch.from_numpy)

    def counted(name):
        fn = real[name]

        def call(data, *a, **kw):
            t0 = time.perf_counter()
            out = fn(data, *a, **kw)
            if name == 'from_numpy' or not isinstance(data, torch.Tensor) \
                    and (out.device.type == 'cuda'
                         or isinstance(data, np.ndarray)):
                seen.append((str(out.device), time.perf_counter() - t0))
            return out
        return call

    for name in real:
        setattr(torch, name, counted(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)


def first_sync(fn) -> str:
    """The traceback of the first synchronizing call of ``fn()`` under
    ``set_sync_debug_mode('error')`` ('' if none)."""
    try:
        with sync_sites('error'):
            fn()
    except RuntimeError as e:
        if 'synchroniz' not in str(e):
            raise
        return traceback.format_exc(limit=-8)
    finally:
        torch.cuda.synchronize()
    return ''


def probe(fn, reps: int) -> dict:
    """``fn()`` once warm, then ``reps`` times between synchronizations
    (host clock and CUDA events), once counting host-array uploads and
    once listing synchronizing calls."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        dev.append(s.elapsed_time(e) / 1e3)
    with numpy_uploads() as up:
        fn()
        torch.cuda.synchronize()
    with sync_sites('warn') as sites:
        fn()
    torch.cuda.synchronize()
    rec = dict(host_s=float(np.median(host)), host_all_s=host,
               event_s=float(np.median(dev)), uploads=len(up),
               upload_s=sum(u[1] for u in up), syncs=sum(sites.values()),
               sync_sites=dict(sites.most_common()))
    if sites:
        rec['first_sync'] = first_sync(fn)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=ROOT,
                    help='the tree whose list_tpu_torch is measured')
    ap.add_argument('--label', default='this tree')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('torch_decode_probe: needs an NVIDIA GPU')
    sys.path.insert(0, os.path.abspath(args.root))
    from list_tpu_torch.config import default_config
    from list_tpu_torch.device import card
    from list_tpu_torch.models import LIST
    from list_tpu_torch.ops.cuda import KERNEL_SOURCES, build
    from list_tpu_torch.train import LISTExecutor
    import list_tpu_torch
    build.build_all(KERNEL_SOURCES)
    out = dict(label=args.label, package=list_tpu_torch.__file__,
               card=card(), torch=torch.__version__)
    print(out['card'], flush=True)

    torch.manual_seed(args.seed)
    cfg = default_config(vox_res=128, sdf_scale=10.0)
    model = LIST.from_config(cfg)
    ex = {R: LISTExecutor(default_config(vox_res=R, sdf_scale=10.0), model)
          for R in (128, 256)}
    rng = np.random.RandomState(args.seed)
    img = torch.as_tensor(rng.rand(1, 224, 224, 3).astype(np.float32),
                          device='cuda')
    with torch.inference_mode():
        out['encode'] = probe(lambda: model.encode(img), 5)
        print('encode', json.dumps(out['encode']), flush=True)
        enc = model.encode(img)
        for R, e in ex.items():
            plan = e._dense_plan(1)
            rec = probe(lambda: e._decode(enc, *plan), 5 if R == 128 else 3)
            out[f'decode_{R}'] = dict(rec, plan=plan)
            print(f'decode {R}', json.dumps(out[f'decode_{R}']), flush=True)
        del enc
    del ex, model
    torch.cuda.empty_cache()

    b, nq, R = 8, 32768, 128
    tcfg = default_config(sdf_scale=10.0, vox_res=R, train_batch_size=b,
                          sample_point_density=nq, sample_distribution=[1.0],
                          train_query_chunks=4, remat_save_samples=1)
    batch = {
        'rgb_image': rng.rand(b, 224, 224, 3).astype(np.float32),
        'points': rng.uniform(-0.5, 0.5, (b, nq, 3)).astype(np.float32),
        'values': (rng.randn(b, nq) * 0.05).astype(np.float32),
        'occ': (rng.rand(b, R, R, R) > 0.99).astype(np.float32),
    }
    torch.manual_seed(args.seed)
    tex = LISTExecutor(tcfg, LIST.from_config(tcfg))
    tex.train(batch)
    steps = []
    for _ in range(3):
        tex.train(batch)
        steps.append(tex.timings['step_s'])
    with sync_sites('warn') as sites:
        tex.train(batch)
    out['step'] = dict(step_s=float(np.median(steps)), step_all_s=steps,
                       syncs=sum(sites.values()),
                       sync_sites=dict(sites.most_common()),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print('step', json.dumps(out['step']), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
