"""Optimizer construction (counterpart of ``list_tpu/train/state.py``).

The JAX package's optax chain add_decayed_weights -> scale_by_adam ->
scale(-lr) is torch's Adam with its coupled weight decay, exactly.
Frozen top-level submodules are left out of the optimizer: they get
neither an update nor weight decay (the JAX package's ``set_to_zero``
branch); their BatchNorm statistics still update in training, as there.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch


def make_optimizer(params: Iterable[Tuple[str, torch.nn.Parameter]],
                   lr: float, beta1: float = 0.9, beta2: float = 0.999,
                   weight_decay: float = 1e-5,
                   frozen_prefixes: Sequence[str] = ()
                   ) -> torch.optim.Adam:
    """``params``: (name, parameter) pairs, as ``named_parameters()``
    gives them; a name whose first component is in ``frozen_prefixes``
    (e.g. ('im_encoder', 'point_decoder')) is frozen."""
    frozen = set(frozen_prefixes)
    trained = [p for name, p in params if name.split('.', 1)[0] not in frozen]
    return torch.optim.Adam(trained, lr=lr, betas=(beta1, beta2), eps=1e-8,
                            weight_decay=weight_decay)
