"""Mesh requests in a closed loop: a fixed number of requests outstanding,
as the test-split sweep keeps them.

A request is a render of one of the traffic's distinct images,
``predict_grid(img, device_out=True)`` on the calling thread (encode, the
dense decode at the configuration's resolution, the band wire's encode),
then ``fetch_grid_f32`` in a pool of fetch workers and ``generate_mesh``
in a pool of mesh workers.  Its latency runs from its submission to its
mesh on the host.  The loop submits the next request when the oldest
one's mesh is done.

Random weights give no surface, so set-up fits them to the traffic with
the configuration's reference (``prepare_mesh`` of
``reference/models/<model>.py``); these weights are those of both sides.
Set-up also runs ``warmup_requests`` through the pipeline.  A sample of
the window's requests, drawn from the seed among the first
``check_window``, is kept and held to the reference after the window.

Modes other than ``program`` serve the calibration of the limits:
``control`` answers the sampled requests with the reference in fp8 (its
decoder) and TF32 (its encoder); ``fault_swap`` mirrors each kept
answer's grid and mesh where they are produced.
"""

from __future__ import annotations

import collections
import gc
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, program, trace, traffic_gen
from benchmark.reference import model, models, weights

WARM_OFFSET = 1 << 40
PROFILE_OFFSET = 1 << 41


def sphere_grid(res: int) -> np.ndarray:
    """A sphere's SDF on a res^3 grid: a mesh to warm the native library."""
    ax = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    return np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                   + ax[None, None, :] ** 2) - 0.5


class Pipeline:
    def __init__(self, ex, cfg: Dict, tr: Dict, imgs: np.ndarray, keep,
                 mode: str):
        self.ex, self.cfg, self.imgs, self.keep = ex, cfg, imgs, set(keep)
        self.mode = mode
        self.out = tr['outstanding']
        self.fetch_pool = ThreadPoolExecutor(tr['fetch_workers'])
        self.mesh_pool = ThreadPoolExecutor(tr['mesh_workers'])
        self.kept: Dict[int, tuple] = {}

    def close(self) -> None:
        self.fetch_pool.shutdown(wait=True)
        self.mesh_pool.shutdown(wait=True)

    def submit(self, i: int):
        t = time.perf_counter()
        res = self.ex.predict_grid(self.imgs[i % len(self.imgs)][None],
                                   device_out=True)
        return self.fetch_pool.submit(self._fetch, i, res, t)

    def _fetch(self, i: int, res, t: float):
        grid = program.fetch(res)
        spans = res.spans.resolve() if getattr(res, 'spans', None) else {}
        return self.mesh_pool.submit(self._mesh, i, grid, t, spans)

    def _mesh(self, i: int, grid, t: float, spans: Dict):
        t1 = time.perf_counter()
        v, _ = program.mesh(grid, self.cfg['bb_min'], self.cfg['bb_max'])
        t2 = time.perf_counter()
        if i in self.keep:
            if self.mode == 'fault_swap':
                grid, v = grid[::-1].copy(), v * np.array([-1.0, 1.0, 1.0])
            self.kept[i] = (grid, v)
        return dict(i=i, t_sub=t, t_done=t2, mc_s=t2 - t1,
                    encode_s=spans.get('encode_s'),
                    decode_s=spans.get('decode_s'))

    def loop(self, first: int, n_min: int, t_end: float, hook=None):
        """Requests first, first + 1, ... while before ``t_end`` or fewer
        than ``n_min`` were submitted; every one drained.  ``hook(k)`` is
        called before the k-th submission.  -> (records, submitted)."""
        inflight, done, i = collections.deque(), [], first
        while True:
            while len(inflight) < self.out and (
                    time.perf_counter() < t_end or i - first < n_min):
                if hook is not None:
                    hook(i - first)
                inflight.append(self.submit(i))
                i += 1
            if not inflight:
                return done, i - first
            done.append(inflight.popleft().result().result())


def profile_steady(pipe: Pipeline, tr: Dict) -> Dict:
    """A trace of ``profile_requests`` submissions in the middle of a
    running loop: profiling starts once ``outstanding`` requests are in
    flight and stops before the loop drains."""
    prof, mark = trace.profile(), record_function(trace.WINDOW)
    warm, n = tr['outstanding'], tr['profile_requests']

    def hook(k: int) -> None:
        if k == warm:
            prof.start()
            mark.__enter__()
        elif k == warm + n:
            mark.__exit__(None, None, None)
            prof.stop()

    pipe.loop(PROFILE_OFFSET, warm + n + 1, 0.0, hook)
    return trace.summarize(prof)


def _control_answer(plain, P, cfg: Dict, img, device):
    with model.precision('fp8'):
        g = plain.sdf_grid(P, cfg, torch.as_tensor(img[None], device=device),
                           cfg['vox_res'], low=True)
    g = (g / cfg['sdf_scale']).cpu().numpy()
    return g, check.place_vertices(check.crossing_vertices(g),
                                   cfg['bb_min'], cfg['bb_max'])[0]


def run(ctx) -> Dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    imgs, shapes = traffic_gen.images(cfg, tr['distinct_images'], ctx.seed,
                                      dev)
    ctx.log(f'traffic at {time.perf_counter() - ctx.t_start:.3f} s')
    plain = models.find(cfg)
    w = weights.make(plain.spec(cfg), ctx.seed, dev)
    fitted = plain.prepare_mesh(cfg, tr, w, imgs, shapes, ctx.seed, dev,
                                ctx.log)
    rng = np.random.default_rng(weights.stream_seed(ctx.seed, 'sample'))
    sample = sorted(int(x) for x in rng.choice(
        tr['check_window'], tr['check_requests'], replace=False))
    ctx.log(f'weights at {time.perf_counter() - ctx.t_start:.3f} s')
    e2e, record, summary, submitted, peak = {}, {}, {}, 0, 0
    if ctx.mode == 'control':
        answers = {i: _control_answer(plain, w, cfg, imgs[i % len(imgs)],
                                      dev) for i in sample}
        del w
        e2e['setup_s'] = time.perf_counter() - ctx.t_start
    else:
        pipe = Pipeline(program.executor(cfg, w, dev), cfg, tr, imgs, sample,
                        ctx.mode)
        del w
        # marching cubes once on this thread: the native library builds
        # and sets up its case tables before the workers share it
        program.mesh(sphere_grid(cfg['vox_res']), cfg['bb_min'],
                     cfg['bb_max'])
        ctx.log(f'executor at {time.perf_counter() - ctx.t_start:.3f} s')
        pipe.loop(WARM_OFFSET, tr['warmup_requests'], 0.0)
        setup_s = time.perf_counter() - ctx.t_start
        t0 = time.perf_counter()
        done, submitted = pipe.loop(0, tr['check_window'], t0 + ctx.seconds)
        if dev.type == 'cuda':
            peak = torch.cuda.max_memory_allocated(dev)
        if ctx.trace:
            summary = profile_steady(pipe, tr)
        answers = pipe.kept
        pipe.close()
        del pipe
        gc.collect()
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        inside = [r for r in done if r['t_done'] <= t0 + ctx.seconds]
        lat = [r['t_done'] - r['t_sub'] for r in inside]
        e2e = {'setup_s': setup_s}
        if inside:
            e2e.update(meshes_per_s=len(inside) / ctx.seconds,
                       mesh_p95_s=float(np.percentile(lat, 95)))
        ctx.log(f'set-up {setup_s:.3f} s; {submitted} requests submitted, '
                f'{len(inside)} meshes in the window')
        record = dict(cfg=cfg, trace=summary,
                      meshes_per_s=e2e.get('meshes_per_s'),
                      requests=inside, resolution=cfg['vox_res'])

    t_ref = time.perf_counter()
    w = weights.make(plain.spec(cfg), ctx.seed, dev)
    for k, t in fitted.items():
        w[k].copy_(t)
    readings, overflows = [], 0
    for i in sample:
        if i not in answers:
            raise RuntimeError(f'request {i} never answered')
        grid, verts = answers[i]
        with model.precision('f32'):
            ref = plain.sdf_grid(w, cfg, torch.as_tensor(
                imgs[i % len(imgs)][None], device=dev), cfg['vox_res'])
        ref = (ref / cfg['sdf_scale']).cpu().numpy()
        if ctx.mode != 'control':
            band = check.mixed_cube_mask(grid > 0)
            overflows += int(np.count_nonzero(np.abs(grid) != 1.0)
                             > band.sum())
        readings.append(check.mesh_readings(grid, verts, ref, cfg['bb_min'],
                                            cfg['bb_max']))
    ctx.log(f'band overflows: {overflows} of {len(sample)} checked answers; '
            f'reference {time.perf_counter() - t_ref:.3f} s')
    return dict(e2e=e2e, readings=check.worst(readings),
                attempted=submitted, failed=0, memory_peak_bytes=peak,
                trace=summary, record=record)
