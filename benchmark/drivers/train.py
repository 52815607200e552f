"""Closed-loop training: one optimizer step at a time through the
executor's ``train`` entry (batch to the device, forward, losses,
backward, Adam, synchronized), over a few distinct host batches cycled.

Set-up builds the executor once with the benchmark's weights and drives
it through its first ``checked_steps`` steps on distinct batches: those
steps warm every shape and give the readings the reference is held to
(each step's losses, the first gradient from Adam's state, the change of
every leaf).  The same executor then runs the window.  After the window
(and the traced sub-window) the program is freed and the reference
repeats the checked steps from the same weights and batches.  The
batches, the leaves and the reference's losses are those of the
configuration's model (``reference/models/<model>.py``).

Modes other than ``program`` serve the calibration of the limits:
``control`` puts the reference, in TF32, in the program's place;
``fault_unchanged`` restores the program's parameters after each step;
``fault_half_batch`` trains the program on the first half of each
batch's rows.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from benchmark import check, program, trace
from benchmark.reference import model, models, weights


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


class Program:
    def __init__(self, cfg: Dict, w: Dict[str, torch.Tensor], device,
                 mode: str):
        self.ex = program.executor(cfg, w, device)
        self.mode = mode

    @staticmethod
    def half(batch):
        """The batch that ``fault_half_batch`` trains on: its first half."""
        return {k: v[:len(v) // 2] for k, v in batch.items()}

    def step(self, batch) -> Dict[str, float]:
        if self.mode == 'fault_half_batch':
            batch = self.half(batch)
        params = list(self.ex.model.parameters())
        if self.mode == 'fault_unchanged':
            kept = [p.detach().clone() for p in params]
        _, losses = self.ex.train(batch)
        if self.mode == 'fault_unchanged':
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
        return losses

    def grads(self) -> Dict[str, float]:
        opt = self.ex.optimizer
        b1 = opt.param_groups[0]['betas'][0]
        names = {id(p): n for n, p in self.ex.model.named_parameters()}
        ps = [p for g in opt.param_groups for p in g['params']]
        return {names[id(p)]: v / (1 - b1) for p, v in
                zip(ps, _norms([opt.state[p]['exp_avg'] for p in ps]))}

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.ex.model.named_parameters())


class Reference:
    """The plain model and torch's Adam, at ``precision``."""

    def __init__(self, cfg: Dict, w: Dict[str, torch.Tensor], device,
                 precision: str):
        self.cfg, self.device, self.precision = cfg, device, precision
        self.ref = models.find(cfg)
        self.P, trained = {}, []
        for name, _, kind, _ in self.ref.spec(cfg):
            t = w[name].detach().clone()
            if weights.trainable(kind):
                t.requires_grad_()
                trained.append(name)
            self.P[name] = t
        self.trained = trained
        self.opt = torch.optim.Adam(
            [self.P[n] for n in trained], lr=cfg['lr'],
            betas=(cfg['beta1'], 0.999), eps=1e-8,
            weight_decay=cfg['weight_decay'])

    def step(self, batch) -> Dict[str, torch.Tensor]:
        b = {k: torch.as_tensor(v, device=self.device, dtype=torch.float32)
             for k, v in batch.items()}
        self.opt.zero_grad(set_to_none=True)
        with model.precision(self.precision):
            losses = self.ref.losses(self.P, self.cfg, b,
                                     self.cfg.get('reference_chunk', 0))
        self.opt.step()
        return losses

    def grads(self) -> Dict[str, float]:
        b1 = self.cfg['beta1']
        ps = [self.P[n] for n in self.trained]
        return {n: v / (1 - b1) for n, v in zip(
            self.trained, _norms([self.opt.state[p]['exp_avg'] for p in ps]))}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: self.P[n] for n in self.trained}


def first_steps(side, batches, w0: Dict[str, torch.Tensor]) -> Dict:
    """Drive ``side`` through one step a batch; its readings."""
    out = {'losses': []}
    for k, b in enumerate(batches):
        losses = side.step(b)
        keys = [n for n in losses if 'ignore' not in n]
        out['losses'].append(dict(zip(keys, torch.stack(
            [losses[n].detach().float() for n in keys]).tolist())))
        if k == 0:
            out['grad'] = side.grads()
    ps = side.params()
    out['change'] = dict(zip(ps, _norms([p.detach() - w0[n]
                                         for n, p in ps.items()])))
    return out


def _sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def reference_steps(cfg: Dict, seed: int, device, batches) -> Dict:
    """The plain reference's first steps from the seed's weights."""
    leaves = models.find(cfg).spec(cfg)
    return first_steps(Reference(cfg, weights.make(leaves, seed, device),
                                 device, 'f32'), batches,
                       weights.make(leaves, seed, device))


def step_times(t0: float, ends: List[float]) -> str:
    """The window's steps by their host-clock lengths: the median, the
    slowest, and the time the steps over 1.5 x the median took beyond it
    (a stall of the host or the card)."""
    d = [b - a for a, b in zip([t0] + ends, ends)]
    if not d:
        return 'no step in the window'
    med = statistics.median(d)
    slow = [x for x in d if x > 1.5 * med]
    q = (statistics.quantiles(d, n=10, method='inclusive') if len(d) > 1
         else [med] * 9)
    beyond = sum(slow) - med * len(slow)
    return (f'step times: {len(d)} steps, median {med:.6f} s, p10 '
            f'{q[0]:.6f}, p90 {q[-1]:.6f}, max {max(d):.6f} s; '
            f'{len(slow)} over 1.5 x the median, {beyond:.6f} s beyond it, '
            f'of {ends[-1] - t0:.6f} s')


def run(ctx) -> Dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    plain = models.find(cfg)
    batches = plain.batches(cfg, tr, ctx.seed, dev)
    nb, n_first = len(batches), tr['checked_steps']
    w = weights.make(plain.spec(cfg), ctx.seed, dev)
    ctx.log(f'traffic and weights at {time.perf_counter() - ctx.t_start:.3f}'
            ' s')
    side = (Reference(cfg, w, dev, 'tf32') if ctx.mode == 'control'
            else Program(cfg, w, dev, ctx.mode))
    ctx.log(f'executor at {time.perf_counter() - ctx.t_start:.3f} s')
    first = first_steps(side, batches[:n_first], w)
    del w
    _sync(dev)
    # what set-up left alive is never collected again: the window's full
    # collections then walk only the objects its steps make
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f'set-up {setup_s:.3f} s; first steps {first["losses"]}')

    steps, i, t0 = 0, n_first, time.perf_counter()
    t, ends = t0, []
    while ctx.seconds > 0 and t - t0 < ctx.seconds:
        side.step(batches[i % nb])
        i, steps = i + 1, steps + 1
        t = time.perf_counter()
        ends.append(t)
    _sync(dev)
    gc.unfreeze()
    ctx.log(step_times(t0, ends))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)

    summary = {}
    if ctx.trace:
        with trace.profile() as prof:
            with record_function(trace.WINDOW):
                for _ in range(tr['profile_steps']):
                    side.step(batches[i % nb])
                    i += 1
                _sync(dev)
        summary = trace.summarize(prof)

    del side
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, ctx.seed, dev, batches[:n_first])
    ctx.log(f'reference {time.perf_counter() - t_ref:.3f} s; losses '
            f'{ref["losses"]}; worst leaves {check.worst_leaves(first, ref)}')
    e2e = {'setup_s': setup_s}
    if steps:
        e2e['train_step_s'] = (t - t0) / steps
    return dict(e2e=e2e, readings=check.train_readings(first, ref),
                checked=(first, ref), attempted=steps, failed=0,
                memory_peak_bytes=peak, trace=summary,
                record=dict(cfg=cfg, trace=summary, steps=steps,
                            profile_steps=tr['profile_steps'],
                            train_step_s=e2e.get('train_step_s')))
