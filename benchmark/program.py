"""The system under test: ``list_tpu_torch``'s executors, built as a
configuration states and loaded with the benchmark's weights.

This is the one module of the benchmark that imports the program, and
only inside its functions.  It takes from the program its executors (the
model and executor classes its registry resolves from the configuration's
``model``), the spans of a request (``DeviceSpans`` through ``timings``),
the mesh extraction, its process group (``parallel/multihost.py``) and
the names of its kernels (``KERNELS``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch

# The program's kernels, by the names the profiler gives them.
KERNELS = {'k1': 'fused_stack_head_kernel', 'k2': 'conv3x3x3_kernel',
           'k3_partial': 'dk_partial_kernel', 'k3_reduce': 'dk_reduce_kernel'}


def cache_dirs(root: str) -> Dict[str, str]:
    """Fixed build and cache directories inside the checkout: the
    program's nvcc and g++ builds, Triton's and PyTorch's extension
    caches, CUDA's JIT cache."""
    b = os.path.join(root, 'build')
    return {'LIST_TPU_TORCH_BUILD': os.path.join(b, 'list_tpu_torch'),
            'TRITON_CACHE_DIR': os.path.join(b, 'triton'),
            'TORCH_EXTENSIONS_DIR': os.path.join(b, 'torch_extensions'),
            'CUDA_CACHE_PATH': os.path.join(b, 'cuda_cache')}


def config(cfg: Dict):
    from list_tpu_torch.config import default_config
    return default_config(**cfg['program_flags'])


def executor(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    """The configuration's executor on ``device``, its model holding
    ``weights`` (every key of its state_dict, shapes checked): the classes
    the program's registry resolves from ``cfg['model']``."""
    from list_tpu_torch import registry
    pcfg = config(cfg)
    model_cls = registry.get_class(cfg['model'])
    ex_cls = registry.get_class(registry.executor_for(cfg['model']))
    with torch.device(device):
        model = model_cls.from_config(pcfg)
    model.load_state_dict(weights, strict=True)
    return ex_cls(pcfg, model, device=device)


def fetch(result):
    """A device result of ``predict_grid(device_out=True)`` -> the f32 host
    grid."""
    from list_tpu_torch.ops.band import fetch_grid_f32
    return fetch_grid_f32(result)


def mesh(grid, bb_min: float, bb_max: float):
    """(vertices, faces) of a host grid, as the sweep extracts them."""
    from list_tpu_torch.utils.meshing import generate_mesh
    return generate_mesh(grid, bb_min, bb_max)



def join_group(address: str, world: int, rank: int, backend: str, device):
    """Join the program's process group as ``rank`` of ``world``, as its
    drivers do under ``--multihost 1``."""
    from list_tpu_torch.parallel import multihost
    return multihost.initialize(address, world, rank, backend=backend,
                                device=device)


def leave_group() -> None:
    from list_tpu_torch.parallel import multihost
    multihost.shutdown()


@contextlib.contextmanager
def no_exchange(ex):
    """The fault of a data-parallel step with the exchange between ranks
    left out: ``ex`` all-reduces no gradient, and its BatchNorms take this
    rank's own moments, not the global batch's."""
    from list_tpu_torch.models import norm
    group = norm.moments_group
    ex._all_reduce_grads = lambda: None
    norm.moments_group = lambda: None
    try:
        yield
    finally:
        norm.moments_group = group
        del ex._all_reduce_grads
