"""The system under test: ``list_tpu_torch``'s executors, built as a
configuration states and loaded with the benchmark's weights.

This is the one module of the benchmark that imports the program, and
only inside its functions.  It takes from the program its executors, the
spans of a request (``DeviceSpans`` through ``timings``), the mesh
extraction and the names of its kernels (``KERNELS``).
"""

from __future__ import annotations

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
    ``weights`` (every key of its state_dict, shapes checked)."""
    from list_tpu_torch.models import LIST, CoarseNet
    from list_tpu_torch.train.executors import (CoarseNetExecutor,
                                                LISTExecutor)
    pcfg = config(cfg)
    model_cls, ex_cls = {'LIST': (LIST, LISTExecutor),
                         'CoarseNet': (CoarseNet, CoarseNetExecutor)}[
        cfg['model']]
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

