"""Device resolution, numeric policy and the build directory.

Entry points take an explicit ``device`` that defaults to ``'cuda'``.  A
CUDA request on a host without a card raises: the port never drops to the
CPU on its own.  Callers (the CPU tests) pass ``device='cpu'`` to run the
plain PyTorch path.

Importing the package switches TF32 off for both matmuls and cuDNN
convolutions (``disable_tf32``): the JAX reference asks for full f32
precision where it matters (its align-corners resize matrices), and cuDNN
convolutions default to TF32 on Hopper.

The H100 SXM's data-sheet rates (``H100_SXM``) are what the kernels'
``bound_ms`` read.  The card's ``nvidia-smi`` line (``card``; every
card's: ``cards``) and the CUDA-event median of a call on a given card
(``time_ms``) serve ``chip_smoke.py``, the tools and the card tests.
"""

from __future__ import annotations

import os
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Union

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's H100 SXM data sheet (NVIDIA H100 80GB HBM3), dense rates at the
# 700 W limit: bf16 tensor-core and f32 (outside the tensor cores) TFLOP/s,
# HBM GB/s.
H100_SXM: Dict[str, float] = dict(bf16_tflops=989.0, f32_tflops=67.0,
                                  mem_gbs=3350.0)


def cards() -> List[str]:
    """Every card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f'nvidia-smi: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()


def card() -> str:
    """The first card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    return cards()[0]


def time_ms(fn: Callable[[], object], reps: int, warm: int = 2,
            device: Optional[Union[str, torch.device]] = None) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms, after ``warm``
    calls; the events go on ``device``'s current stream (default: the
    current device's), the card ``fn`` works on."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record(stream)
        fn()
        e.record(stream)
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(statistics.median(ts))


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "list_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            'the plain PyTorch path')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'list_tpu_torch: unsupported device {dev}')
    return dev


def build_dir() -> str:
    """Directory for compiled kernels and the native mesh library:
    ``$LIST_TPU_TORCH_BUILD`` or ``build/list_tpu_torch`` beside the
    package (git-ignored)."""
    d = os.environ.get('LIST_TPU_TORCH_BUILD') or os.path.join(
        os.path.dirname(_PKG_DIR), 'build', 'list_tpu_torch')
    os.makedirs(d, exist_ok=True)
    return d
