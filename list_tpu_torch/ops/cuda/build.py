"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``lib<name>.so`` in the package build directory
(git-ignored), then loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  Nothing is built or loaded at import:
the first launch builds, and ``build_all`` compiles every source in
parallel (one ``nvcc`` process each).

``launch`` calls a launcher with the operands' card as the current device:
``cudaFuncSetAttribute`` and ``<<<..., stream>>>`` act on the calling
thread's current device, and a launch into another card's stream is not
refused there: its kernel faults on an illegal address, reported by a
later call.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

from list_tpu_torch.device import build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'csrc')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo',
              '-Xptxas', '-v']

_lock = threading.Lock()
# held by the wrappers around their launch counters: the split decode
# launches K1 from one host thread per card
count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get('CUDACXX'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('list_tpu_torch: nvcc not found (set CUDACXX)')


def _paths(name: str):
    src = os.path.join(CSRC, f'{name}.cu')
    so = os.path.join(build_dir(), f'lib{name}.so')
    return src, so


def _stale(name: str) -> bool:
    """No library yet, or older than its source or any shared header."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + glob.glob(os.path.join(CSRC, '*.cuh'))
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def _start(name: str) -> subprocess.Popen:
    src, so = _paths(name)
    tmp = f'{so}.{os.getpid()}.tmp'
    return subprocess.Popen([nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    src, so = _paths(name)
    with open(so + '.log', 'w') as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {src}:\n{out}')
    os.replace(f'{so}.{os.getpid()}.tmp', so)
    return out


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale source at once; returns nvcc's output (register
    and shared-memory use from ``-Xptxas -v``) per kernel source."""
    with _lock:
        procs = {n: _start(n) for n in names if _stale(n)}
        return {n: _finish(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what}: kernel launch failed (code {rc})')


def launch(device: torch.device, what: str, fn, *args) -> None:
    """``fn(*args, stream)``, a ctypes launcher, on ``device``'s current
    stream with ``device`` (the operands' card) current for the call; the
    caller's current device comes back afterwards.  A non-zero return
    raises."""
    with torch.cuda.device(device):
        rc = fn(*args, stream_handle(device))
    check(rc, what)
