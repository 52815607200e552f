"""BatchNorm with flax's running-statistics update, and the checkpoint
wrapper the train path uses around it.

``BatchNorm`` normalizes over every axis but axis 1 (channels), with
eps 1e-5 as every BatchNorm of the JAX package.  In training it normalizes
with the biased batch statistics, as ``nn.BatchNorm*d`` does, but updates
``running_mean``/``running_var`` as ``0.9 * old + 0.1 * batch`` with the
**biased** batch variance, as flax's ``nn.BatchNorm(momentum=0.9)`` does
(torch's stock module uses the unbiased variance there).  In eval mode it
normalizes with the running statistics.

``checkpoint(fn, *args)`` is ``torch.utils.checkpoint`` (non-reentrant)
whose recomputed forward leaves the running statistics alone, so a step
updates them once, as flax's ``nn.remat`` returns the mutated
``batch_stats`` once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

EPS = 1e-5
MOMENTUM = 0.1  # weight of the batch statistics in the running ones

# > 0 while a checkpointed region's forward is being recomputed.  Module
# state, not thread-local: the backward (and so the recompute) of CUDA
# tensors runs on the autograd engine's device thread.
_recomputing = 0


@contextlib.contextmanager
def _recompute():
    global _recomputing
    _recomputing += 1
    try:
        yield
    finally:
        _recomputing -= 1


def _contexts():
    return contextlib.nullcontext(), _recompute()


def checkpoint(fn, *args):
    """Run ``fn(*args)`` keeping only its inputs and outputs for backward;
    the backward recomputes it (no BatchNorm statistics update then)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=_contexts)


class BatchNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, EPS)
        if not _recomputing:
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                self.running_mean.mul_(1.0 - MOMENTUM).add_(mean,
                                                            alpha=MOMENTUM)
                self.running_var.mul_(1.0 - MOMENTUM).add_(var, alpha=MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, EPS)
