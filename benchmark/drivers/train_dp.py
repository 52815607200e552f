"""Closed-loop data-parallel training: one optimizer step at a time over
the traffic's ``ranks`` processes, one a card, in the program's process
group (``parallel/multihost.py``: NCCL on cards; gloo on the CPU, or where
the ranks outnumber the cards, since NCCL takes one rank a card).

Every rank runs the program's normal data-parallel path: the executor
broadcasts rank 0's state when it is built, and each ``train(batch)``
takes the global batch, keeps this rank's rows (``parallel/mesh.py``
``shard_batch``), normalizes with the global batch's BatchNorm moments,
all-reduces the gradients (the span ``step.allreduce``) and applies Adam.
The harness's process is rank 0: its clock, its trace and its memory peak
are the cell's, and ``memory_peak_bytes`` is the fullest card's.  Ranks 1
and up are spawned processes that make the same weights and batches from
the seed.

Set-up drives every rank through ``checked_steps`` steps, as
``drivers/train.py`` does; rank 0's readings (its losses, the first
gradient from its Adam state, the change of its leaves) are held to the
one-device reference on the whole global batch, and read besides as
``grad_gap_median``, the median leaf's first-gradient gap.  ``rank_gap``
is then the largest difference of any parameter between rank 0 and the
other ranks.  The window's step count is set once, from rank 0's pace in
the last checked step, and broadcast, so that no message but the
program's own passes between the ranks in the window.  Every rank leaves
the group and its process ends before the reference runs.

Modes other than ``program``: ``control`` is ``drivers/train.py``'s (the
reference in TF32 on the global batch, in one process);
``fault_unchanged`` restores every rank's parameters after each step;
``fault_half_batch`` trains each rank on half of its rows;
``fault_no_exchange`` leaves the gradients' and the BatchNorm moments'
all-reduces out.
"""

from __future__ import annotations

import contextlib
import gc
import math
import multiprocessing
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from benchmark import check, program, trace
from benchmark.drivers import train
from benchmark.reference import models, weights


class Program(train.Program):
    """A rank's side of ``drivers/train.py``, timing each step (``train``
    returns synchronized)."""

    last_s = 0.0

    @staticmethod
    def half(batch):
        """Every other row of the global batch: each rank's share is then
        every other row of its own."""
        return {k: v[::2] for k, v in batch.items()}

    def step(self, batch) -> Dict[str, float]:
        t = time.perf_counter()
        losses = super().step(batch)
        self.last_s = time.perf_counter() - t
        return losses


def _device(kind: str, rank: int) -> torch.device:
    if kind == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', rank % torch.cuda.device_count())


def _backend(dev: torch.device, world: int) -> str:
    return ('nccl' if dev.type == 'cuda'
            and torch.cuda.device_count() >= world else 'gloo')


def _rank_gap(side: Program) -> float:
    """The largest difference of any parameter from rank 0's."""
    flat = torch.cat([p.detach().reshape(-1)
                      for p in side.ex.model.parameters()])
    base = flat.clone()
    dist.broadcast(base, 0)
    gap = (flat - base).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _window_steps(pace_s: float, seconds: float, dev) -> int:
    """Rank 0's step count for the window, given to every rank."""
    n = math.ceil(seconds / pace_s) if seconds > 0 else 0
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t)


def _peaks(peak: int, dev, world: int) -> List[int]:
    t = torch.tensor([peak], dtype=torch.int64, device=dev)
    out = [torch.zeros_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return [int(x) for x in out]


def _session(job: Dict, rank: int, log: Callable[[str], None],
             t_start: float) -> Optional[Dict]:
    """One rank's part of a run; -> rank 0's measurements, None on the
    other ranks.  The process group is left on return."""
    cfg, tr, seed = job['cfg'], job['traffic'], job['seed']
    world, n_first = tr['ranks'], tr['checked_steps']
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = _device(job['device'], rank)
    program.join_group(job['address'], world, rank, _backend(dev, world),
                       dev)
    try:
        plain = models.find(cfg)
        batches = plain.batches(cfg, tr, seed, dev)
        w = weights.make(plain.spec(cfg), seed, dev)
        side = Program(cfg, w, dev, job['mode'])
        if rank == 0:
            log(f'traffic, weights and executor at '
                f'{time.perf_counter() - t_start:.3f} s')
        fault = (program.no_exchange(side.ex)
                 if job['mode'] == 'fault_no_exchange'
                 else contextlib.nullcontext())
        with fault:
            first = train.first_steps(side, batches[:n_first], w)
            del w
            gap = _rank_gap(side)
            steps = _window_steps(side.last_s, job['seconds'], dev)
            i, nb = n_first, len(batches)
            train._sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                side.step(batches[i % nb])
                i += 1
            train._sync(dev)
            t = time.perf_counter()
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == 'cuda' else 0)
            summary = {}
            if job['trace']:
                with (trace.profile() if rank == 0
                      else contextlib.nullcontext()) as prof:
                    with record_function(trace.WINDOW):
                        for _ in range(tr['profile_steps']):
                            side.step(batches[i % nb])
                            i += 1
                        train._sync(dev)
                if rank == 0:
                    summary = trace.summarize(prof)
            peaks = _peaks(peak, dev, world)
    finally:
        program.leave_group()
    if rank:
        return None
    del side
    return dict(first=first, rank_gap=gap, steps=steps, t0=t0, t=t,
                peaks=peaks, summary=summary, batches=batches[:n_first],
                setup_s=t0 - t_start)


def rank_main(job: Dict, rank: int) -> None:
    """A spawned rank's process."""
    def log(msg: str) -> None:
        print(f'benchmark: rank {rank}: {msg}', file=sys.stderr, flush=True)

    _session(job, rank, log, time.perf_counter())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _watch(procs, done: threading.Event, log) -> None:
    """Ends the run when a rank's process fails: rank 0 would wait for it
    in a collective."""
    while not done.wait(1.0):
        failed = [(r, p.exitcode) for r, p in enumerate(procs, 1)
                  if p.exitcode not in (None, 0)]
        if failed:
            log(f'rank(s) failed, (rank, exit code): {failed}')
            for p in procs:
                p.kill()
            os._exit(1)


def run(ctx) -> Dict:
    if ctx.mode == 'control':
        out = train.run(ctx)
        out['readings']['grad_gap_median'] = check.median_grad_gap(
            *out['checked'])
        return out
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    job = dict(cfg=cfg, traffic=tr, seed=ctx.seed, seconds=ctx.seconds,
               trace=ctx.trace, mode=ctx.mode, device=dev.type,
               address=f'localhost:{_free_port()}')
    spawn = multiprocessing.get_context('spawn')
    procs = [spawn.Process(target=rank_main, args=(job, r), daemon=True)
             for r in range(1, tr['ranks'])]
    for p in procs:
        p.start()
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done, ctx.log),
                     daemon=True).start()
    try:
        out = _session(job, 0, ctx.log, ctx.t_start)
        for p in procs:
            p.join(timeout=120)
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f'ranks 1-{len(procs)} exited with {codes}')
    ctx.log(f'set-up {out["setup_s"]:.3f} s; first steps '
            f'{out["first"]["losses"]}; rank_gap {out["rank_gap"]!r}; '
            f'window {out["steps"]} steps')
    ctx.log(f'memory peaks by rank {out["peaks"]} bytes')

    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = train.reference_steps(cfg, ctx.seed, dev, out['batches'])
    ctx.log(f'reference {time.perf_counter() - t_ref:.3f} s; losses '
            f'{ref["losses"]}; worst leaves '
            f'{check.worst_leaves(out["first"], ref)}')
    readings = dict(check.train_readings(out['first'], ref),
                    grad_gap_median=check.median_grad_gap(out['first'], ref),
                    rank_gap=out['rank_gap'])
    steps, summary = out['steps'], out['summary']
    e2e = {'setup_s': out['setup_s']}
    if steps:
        e2e['train_step_s'] = (out['t'] - out['t0']) / steps
    return dict(e2e=e2e, readings=readings, attempted=steps, failed=0,
                memory_peak_bytes=max(out['peaks']), trace=summary,
                record=dict(cfg=cfg, trace=summary, steps=steps,
                            profile_steps=tr['profile_steps'],
                            train_step_s=e2e.get('train_step_s')))
