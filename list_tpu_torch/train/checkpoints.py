"""Checkpoints of the port (counterpart of
``list_tpu/train/checkpoints.py``).

Two formats hold the same payload, ``{epoch, state_dict, optimizer,
bestloss, step}`` (the reference's dict):

- the JAX package's ``.ckpt``: flax msgpack, ``state_dict`` the flax
  ``{'params', 'batch_stats'}`` tree, read with ``utils/flax_msgpack.py``
  and loaded through ``bridge.load_flax_variables``;
- the port's own: a ``torch.save`` zip archive, ``state_dict`` the model's.

``load_checkpoint`` tells them apart by content (a zip archive or not),
never by file name.  Optimizer state and submodule checkpoints are not
restored yet (resume and warm start come with the trainer).
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional, Tuple, Union

import torch

from list_tpu_torch.bridge import load_flax_variables
from list_tpu_torch.utils import flax_msgpack


def save_checkpoint(epoch: int, model: torch.nn.Module, bestloss: float,
                    path: str,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> None:
    """Write the torch-format checkpoint atomically; ``epoch + 1`` is
    stored, as the JAX package stores it."""
    payload = {
        'epoch': int(epoch) + 1,
        'state_dict': {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        'optimizer': None if optimizer is None else optimizer.state_dict(),
        'bestloss': float(bestloss),
        'step': int(step),
    }
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    with_step: bool = False
                    ) -> Union[Tuple[int, float], Tuple[int, float, int]]:
    """Load a JAX-package or torch-format checkpoint's weights into
    ``model`` in place (strict) -> (epoch, bestloss), or with
    ``with_step`` (epoch, bestloss, step): the saved optimizer step, 0
    where the file has none (as the JAX package restores it)."""
    if zipfile.is_zipfile(path):
        payload = torch.load(path, map_location='cpu', weights_only=True)
        model.load_state_dict(payload['state_dict'], strict=True)
    else:
        with open(path, 'rb') as f:
            payload = flax_msgpack.msgpack_restore(f.read())
        load_flax_variables(model, payload['state_dict'])
    epoch, bestloss = int(payload['epoch']), float(payload.get('bestloss',
                                                               1e7))
    if with_step:
        return epoch, bestloss, int(payload.get('step', 0))
    return epoch, bestloss
