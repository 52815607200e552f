"""Checkpoints of the port (counterpart of
``list_tpu/train/checkpoints.py``).

Two formats hold the same payload, ``{epoch, state_dict, optimizer,
bestloss, step}`` (the reference's dict):

- the JAX package's ``.ckpt`` (``fmt='flax'``, what the trainer writes):
  flax msgpack, ``state_dict`` the flax ``{'params', 'batch_stats'}`` tree
  and ``optimizer`` optax's state of the torch-Adam-parity chain, so
  ``list_tpu`` resumes and runs it as its own; read and written with
  ``utils/flax_msgpack.py`` through ``bridge.py``;
- the port's own (``fmt='torch'``): a ``torch.save`` zip archive,
  ``state_dict`` the model's and ``optimizer`` Adam's moments by parameter
  name, ``{'count', 'exp_avg', 'exp_avg_sq'}``.

``load_checkpoint`` tells them apart by content (a zip archive or not),
never by file name.  Adam's state maps one to one: optax's
``ScaleByAdamState`` ``count``, ``mu`` and ``nu`` are torch Adam's
``step``, ``exp_avg`` and ``exp_avg_sq``; a parameter the optimizer
leaves out (frozen) has optax's masked moment ``{}`` under the
``set_to_zero`` branch of its ``multi_transform`` state, and no entry in
the torch format.  The optimizer being restored must train exactly the
parameters the file holds moments for, or the load raises, as the JAX
package's does.

Submodule checkpoints (``best_IME_test`` / ``best_PD_test``) are the JAX
package's msgpack ``{epoch, state_dict}`` of one top-level submodule.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from list_tpu_torch.bridge import (flax_to_state_dict, load_flax_variables,
                                   state_dict_to_flax)
from list_tpu_torch.utils import flax_msgpack


def write_atomic(path: str, blob_or_payload, fmt: str) -> None:
    """Atomic write (a temporary file renamed over ``path``)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    if fmt == 'torch':
        torch.save(blob_or_payload, tmp)
    else:
        with open(tmp, 'wb') as f:
            f.write(blob_or_payload)
    os.replace(tmp, path)


def read_payload(path: str) -> Tuple[dict, bool]:
    """(payload, is the torch format)."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location='cpu', weights_only=True), True
    with open(path, 'rb') as f:
        return flax_msgpack.msgpack_restore(f.read()), False


def _trained(model: torch.nn.Module, optimizer: torch.optim.Optimizer
             ) -> Dict[str, torch.nn.Parameter]:
    ids = {id(p) for g in optimizer.param_groups for p in g['params']}
    return {k: p for k, p in model.named_parameters() if id(p) in ids}


def _adam_moments(model, optimizer):
    """(count, exp_avg, exp_avg_sq) of the optimizer's parameters by name;
    zeros before the first step, as optax initializes them."""
    count, mu, nu = 0, {}, {}
    for k, p in _trained(model, optimizer).items():
        s = optimizer.state.get(p, {})
        if s:
            count = int(s['step'])
        mu[k] = s.get('exp_avg', torch.zeros_like(p)).detach().cpu()
        nu[k] = s.get('exp_avg_sq', torch.zeros_like(p)).detach().cpu()
    return count, mu, nu


def _optax_state(model, optimizer) -> dict:
    """The state dict of the JAX package's ``make_optimizer`` chain
    (add_decayed_weights, scale_by_adam, scale), wrapped in its
    ``multi_transform`` when the optimizer leaves parameters out."""
    count, mu, nu = _adam_moments(model, optimizer)
    like = model.state_dict()
    names = [k for k, _ in model.named_parameters()]
    tree = lambda m: state_dict_to_flax(  # noqa: E731
        {k: m.get(k) for k in names}, like)['params']
    chain = {'0': {}, '1': {'count': np.asarray(count, np.int32),
                            'mu': tree(mu), 'nu': tree(nu)}, '2': {}}
    if len(mu) == len(names):
        return chain
    return {'inner_states': {'frozen': {'inner_state': {}},
                             'train': {'inner_state': chain}}}


def _restore_adam(model, optimizer, payload_opt, torch_format: bool) -> None:
    if torch_format:
        count = int(payload_opt['count'])
        mu, nu = payload_opt['exp_avg'], payload_opt['exp_avg_sq']
    else:
        if 'inner_states' in payload_opt:
            payload_opt = payload_opt['inner_states']['train']['inner_state']
        adam = payload_opt['1']
        count = int(adam['count'])
        mu = flax_to_state_dict({'params': adam['mu']})
        nu = flax_to_state_dict({'params': adam['nu']})
    trained = _trained(model, optimizer)
    if set(mu) != set(trained):
        raise ValueError(
            f'checkpoint optimizer state: moments of {len(mu)} parameters, '
            f'the optimizer trains {len(trained)} '
            f'(first differences: '
            f'{sorted(set(mu) ^ set(trained))[:4]})')
    for k, p in trained.items():
        m, v = (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.array(a)) for a in (mu[k], nu[k]))
        if tuple(m.shape) != tuple(p.shape):
            raise ValueError(f'checkpoint optimizer state: {k} has shape '
                             f'{tuple(m.shape)}, the parameter '
                             f'{tuple(p.shape)}')
        optimizer.state[p] = {
            'step': torch.tensor(float(count)),
            'exp_avg': m.to(device=p.device, dtype=p.dtype).clone(),
            'exp_avg_sq': v.to(device=p.device, dtype=p.dtype).clone()}


def save_checkpoint(epoch: int, model: torch.nn.Module, bestloss: float,
                    path: str,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, fmt: str = 'torch') -> None:
    """Write a checkpoint atomically in ``fmt`` ('flax': the JAX
    package's msgpack; 'torch'); ``epoch + 1`` is stored, as the JAX
    package stores it."""
    if fmt == 'flax':
        payload = {
            'epoch': int(epoch) + 1,
            'state_dict': state_dict_to_flax(model.state_dict()),
            'optimizer': (None if optimizer is None
                          else _optax_state(model, optimizer)),
            'bestloss': float(bestloss),
            'step': int(step),
        }
        write_atomic(path, flax_msgpack.msgpack_serialize(payload), fmt)
        return
    if fmt != 'torch':
        raise ValueError(f"checkpoint format {fmt!r}: use 'flax' or 'torch'")
    opt = None
    if optimizer is not None:
        count, mu, nu = _adam_moments(model, optimizer)
        opt = {'count': count, 'exp_avg': mu, 'exp_avg_sq': nu}
    write_atomic(path, {
        'epoch': int(epoch) + 1,
        'state_dict': {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        'optimizer': opt,
        'bestloss': float(bestloss),
        'step': int(step),
    }, fmt)


def load_checkpoint(path: str, model: Optional[torch.nn.Module],
                    with_step: bool = False,
                    optimizer: Optional[torch.optim.Optimizer] = None):
    """Load a JAX-package or torch-format checkpoint's weights into
    ``model`` in place (strict; ``None`` reads the numbers only), and its
    Adam state into ``optimizer`` when one is given and the file has one
    -> (epoch, bestloss), or with ``with_step`` (epoch, bestloss, step):
    the saved optimizer step, 0 where the file has none (as the JAX
    package restores it)."""
    payload, torch_format = read_payload(path)
    if model is not None:
        if torch_format:
            model.load_state_dict(payload['state_dict'], strict=True)
        else:
            load_flax_variables(model, payload['state_dict'])
        if optimizer is not None and payload.get('optimizer') is not None:
            _restore_adam(model, optimizer, payload['optimizer'],
                          torch_format)
    epoch, bestloss = int(payload['epoch']), float(payload.get('bestloss',
                                                               1e7))
    if with_step:
        return epoch, bestloss, int(payload.get('step', 0))
    return epoch, bestloss


def save_submodule(epoch: int, model: torch.nn.Module, name: str,
                   path: str) -> None:
    """Split a top-level submodule's params + stats into its own
    checkpoint (the best_IME_test / best_PD_test recipe)."""
    tree = state_dict_to_flax(getattr(model, name).state_dict())
    write_submodule(int(epoch), tree['params'], tree['batch_stats'], path)


def write_submodule(epoch: int, params: dict, batch_stats: dict,
                    path: str) -> None:
    """The JAX package's submodule checkpoint of flax trees."""
    write_atomic(path, flax_msgpack.msgpack_serialize(
        {'epoch': epoch, 'state_dict': {'params': params,
                                        'batch_stats': batch_stats}}),
        'flax')


def load_submodule(path: str, model: torch.nn.Module, name: str) -> None:
    """Restore one top-level submodule from a submodule checkpoint (warm
    start), strictly."""
    payload, _ = read_payload(path)
    load_flax_variables(getattr(model, name), payload['state_dict'])
