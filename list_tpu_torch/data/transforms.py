"""Image conversion of the test path (``to_float``, copied from
``list_tpu/data/transforms.py``; the training augmentations are not
ported yet)."""

from __future__ import annotations

import numpy as np


def to_float(img) -> np.ndarray:
    """PIL/uint8 -> float32 (H, W, 3) in [0, 1] (ToTensor without the CHW
    transpose)."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.ascontiguousarray(arr[..., :3], np.float32)
