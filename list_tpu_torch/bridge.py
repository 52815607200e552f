"""Weight bridge: the JAX package's ``{'params', 'batch_stats'}`` trees
(nested dicts of numpy arrays, or of torch tensors for a checkpoint's
bfloat16 leaves) -> the port's ``state_dict``.

The port's submodules carry the flax module names, so a flax path maps to
a torch key by name; only the leaf names and layouts change:

- Dense ``kernel`` (I, O) -> Linear ``weight`` (O, I);
- 2-D ``kernel`` (kh, kw, I, O) -> Conv2d ``weight`` (O, I, kh, kw);
- ``_Conv3`` ``kernel`` (3, 3, 3, I, O) -> Conv3d ``weight`` (O, I, 3, 3, 3);
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> ``weight``/``bias`` +
  ``running_mean``/``running_var``;
- TreeGCN ``W_branch`` (node, in, degree*in) and its (1, degree, out)
  ``bias`` are copied as they are.

Strict: a flax leaf with no torch key, a torch key with no flax leaf (other
than BatchNorm's ``num_batches_tracked``), or a shape mismatch raises.

``state_dict_to_flax`` is the inverse, from the torch keys alone (a
module's ``weight`` is a BatchNorm ``scale`` when the module has a
``running_mean``, else a ``kernel``), for writing the JAX package's
checkpoints.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

_PARAM_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
               'W_branch': 'W_branch'}
_STAT_LEAF = {'mean': 'running_mean', 'var': 'running_var'}
_KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f'{prefix}.{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _convert_param(leaf: str, a):
    """Kernel layouts to torch's; ``a`` is a numpy array or (a bfloat16
    leaf of a checkpoint) a torch tensor."""
    if leaf != 'kernel':
        return a
    axes = _KERNEL_AXES.get(a.ndim)
    if axes is None:
        raise ValueError(f'bridge: unexpected kernel rank {a.ndim}')
    return (a.permute(axes) if isinstance(a, torch.Tensor)
            else np.transpose(a, axes))


def flax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """Convert a flax variables tree to torch-keyed numpy arrays."""
    extra = set(variables) - {'params', 'batch_stats'}
    if extra:
        raise KeyError(f'bridge: unexpected collections {sorted(extra)}')
    sd = {}
    for collection, table in (('params', _PARAM_LEAF),
                              ('batch_stats', _STAT_LEAF)):
        for path, a in _flatten(variables.get(collection, {})).items():
            mod, _, leaf = path.rpartition('.')
            if leaf not in table:
                raise KeyError(f'bridge: no torch counterpart for '
                               f'{collection}/{path}')
            key = f'{mod}.{table[leaf]}' if mod else table[leaf]
            if key in sd:
                raise KeyError(f'bridge: two flax leaves map to {key}')
            sd[key] = (_convert_param(leaf, a) if collection == 'params'
                       else a)
    return sd


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a flax ``{'params', 'batch_stats'}`` tree into ``model``
    in place (strict)."""
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    expected = {k for k in own if not k.endswith('num_batches_tracked')}
    missing, unused = sorted(expected - set(sd)), sorted(set(sd) - expected)
    if missing or unused:
        raise KeyError(f'bridge: missing torch keys {missing[:8]} '
                       f'(of {len(missing)}), unused flax leaves '
                       f'{unused[:8]} (of {len(unused)})')
    new = {}
    for k, t in own.items():
        if k.endswith('num_batches_tracked'):
            new[k] = t
            continue
        a = sd[k]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f'bridge: {k} has shape {tuple(a.shape)}, '
                             f'model expects {tuple(t.shape)}')
        new[k] = (a.to(t.dtype).clone() if isinstance(a, torch.Tensor)
                  else torch.tensor(np.array(a), dtype=t.dtype))
    model.load_state_dict(new, strict=True)
    return model


def state_dict_to_flax(sd: Mapping[str, Optional[torch.Tensor]],
                       like: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict:
    """Torch-keyed tensors -> the flax ``{'params', 'batch_stats'}`` tree
    of numpy arrays.  ``like`` (default ``sd``) is the model's state dict,
    which tells BatchNorm weights from kernels when ``sd`` holds
    parameter-shaped tensors only (Adam's moments); a ``None`` tensor
    becomes an empty leaf ``{}`` (optax's masked moment of a frozen
    parameter)."""
    like = sd if like is None else like
    norms = {k.rpartition('.')[0] for k in like if k.endswith('.running_mean')}
    stats = {v: k for k, v in _STAT_LEAF.items()}
    out = {'params': {}, 'batch_stats': {}}
    for key, t in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        mod, _, leaf = key.rpartition('.')
        a = {} if t is None else t.detach().cpu().numpy()
        collection = 'params'
        if leaf in stats:
            collection, leaf = 'batch_stats', stats[leaf]
        elif leaf == 'weight' and mod in norms:
            leaf = 'scale'
        elif leaf == 'weight':
            leaf = 'kernel'
            if t is not None:
                axes = _KERNEL_AXES.get(a.ndim)
                if axes is None:
                    raise ValueError(f'bridge: unexpected weight rank '
                                     f'{a.ndim} at {key}')
                a = np.ascontiguousarray(np.transpose(a, np.argsort(axes)))
        node = out[collection]
        for part in (mod.split('.') if mod else []):
            node = node.setdefault(part, {})
        node[leaf] = a
    return out
