"""Model/dataset/executor registry (counterpart of ``list_tpu/registry.py``).

The same reference dotted paths and short names as the JAX package, each
pointing at the port's class, so an experiment command runs under either
package.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

# Reference dotted path -> the port's dotted path.
_ALIASES: Dict[str, str] = {
    'network.models.CoarseNet': 'list_tpu_torch.models.CoarseNet',
    'network.models.LIST': 'list_tpu_torch.models.LIST',
    'network.executors.CoarseNet':
        'list_tpu_torch.train.executors.CoarseNetExecutor',
    'network.executors.LIST': 'list_tpu_torch.train.executors.LISTExecutor',
    'datasets.Datasets.IM2PointFarthest':
        'list_tpu_torch.data.IM2PointFarthest',
    'datasets.Datasets.IM2SDF': 'list_tpu_torch.data.IM2SDF',
    'datasets.Datasets.Pix3D': 'list_tpu_torch.data.Pix3D',
    'datasets.Datasets.Synthetic': 'list_tpu_torch.data.SyntheticSDFDataset',
    # Short names for convenience.
    'CoarseNet': 'list_tpu_torch.models.CoarseNet',
    'LIST': 'list_tpu_torch.models.LIST',
    'DISN': 'list_tpu_torch.models.disn.DISN',
    'IM2PointFarthest': 'list_tpu_torch.data.IM2PointFarthest',
    'IM2SDF': 'list_tpu_torch.data.IM2SDF',
    'Pix3D': 'list_tpu_torch.data.Pix3D',
    'Synthetic': 'list_tpu_torch.data.SyntheticSDFDataset',
}


def resolve(kls: str) -> str:
    return _ALIASES.get(kls, kls)


def get_class(kls: str) -> Any:
    """Import and return the class named by dotted path ``kls``.

    Accepts reference-style paths (``network.models.LIST``) and the port's
    (``list_tpu_torch.models.LIST``)."""
    kls = resolve(kls)
    module_name, _, attr = kls.rpartition('.')
    if not module_name:
        raise ValueError(f'Expected dotted path, got {kls!r}')
    m = importlib.import_module(module_name)
    return getattr(m, attr)


def executor_for(model_path: str) -> str:
    """The executor path of a model path: the reference's
    ``config.model.replace('model', 'executor')`` idiom for both naming
    schemes."""
    model_path = resolve(model_path)
    if model_path.startswith('list_tpu_torch.models.'):
        name = model_path.rsplit('.', 1)[1]
        return f'list_tpu_torch.train.executors.{name}Executor'
    return model_path.replace('model', 'executor')
