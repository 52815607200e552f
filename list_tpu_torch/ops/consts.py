"""Host-built constants kept on each device.

The JAX package jits its paths, so the numpy plans of the dense decode
(row indices, x-lerp plans, resample indices and weights), the resize
matrices and the displacement table are constants of the compiled
executable: they reach the device once, when it is compiled.  The port
runs eagerly; ``device_const`` gives it the same: the first call for a
``(device, dtype, key)`` builds the array on the host and uploads it, and
every later call returns the same tensor without touching the host.  An
upload from pageable memory makes PyTorch synchronize the stream, so a
path whose constants all come from here never waits on the card once warm.

- ``key`` holds the arguments that define the array (for example
  ``('resample', r_out, r_in, shift, bb_min, bb_max)``); ``make()`` builds
  it, only on a miss.  ``'cuda'`` resolves to the current card's index, so
  ``cuda`` and ``cuda:0`` share an entry and ``cuda:1`` has its own.
- A cached tensor is shared by every caller: it is never written in place.
  ``dtype`` is applied on the device, after the upload in the array's own
  dtype, as the callers cast before.
- Entries are made with inference mode and autograd off: a tensor made
  under ``torch.inference_mode()`` (``predict_grid``) could not be saved
  for a later train step's backward.
- The cache is a bounded LRU (``MAX_ENTRIES``) behind a lock: a caller
  may decode from several host threads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional

import numpy as np
import torch

MAX_ENTRIES = 512


def resolve_device(device) -> torch.device:
    """``device`` with a card index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class ConstCache:
    """A bounded LRU of device tensors keyed on (device, dtype, key)."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def get(self, key: Hashable, make: Callable[[], np.ndarray], device,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        k = (resolve_device(device), dtype, key)
        with self._lock:
            t = self._entries.get(k)
            if t is not None:
                self._entries.move_to_end(k)
                return t
        with torch.inference_mode(False), torch.no_grad():
            t = torch.as_tensor(np.ascontiguousarray(make()), device=k[0])
            if dtype is not None:
                t = t.to(dtype)
        with self._lock:
            t = self._entries.setdefault(k, t)
            self._entries.move_to_end(k)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return t


CONSTS = ConstCache()
# device_const(key, make, device, dtype=None): ``make()`` as a read-only
# tensor on ``device`` (cast to ``dtype`` there), from the process's cache
device_const = CONSTS.get
