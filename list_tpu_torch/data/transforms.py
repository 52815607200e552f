"""Image augmentation pipeline (host-side, NumPy/PIL), copied from
``list_tpu/data/transforms.py`` apart from imports: PIL is imported where
an image is resized.

Reproduces the reference's torchvision transform stack
(datasets/Datasets.py:20-53): optional RandomHorizontalFlip(0.5), optional
ColorJitter(brightness=0.3, saturation=0.5, hue=0.5), ToTensor (/255), and
Normalize((0,0,0),(1,1,1)) — which is an identity op (SURVEY.md §3.6) kept
for flag parity.  All randomness flows through an explicit
``np.random.Generator`` (the reference mixes seeded torch and unseeded
``random``; we fix that).

Output layout is channels-last (H, W, 3) float32 — TPU-native.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def to_float(img) -> np.ndarray:
    """PIL/uint8 -> float32 (H, W, 3) in [0, 1] (ToTensor without the CHW
    transpose)."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.ascontiguousarray(arr[..., :3], np.float32)


def hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(h.shape + (3,), np.float32)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    for k, (rr, gg, bb) in enumerate(conds):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return np.clip(gray + factor * (img - gray), 0.0, 1.0)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    h, s, v = _rgb_to_hsv(img)
    h = (h + shift) % 1.0
    return np.clip(_hsv_to_rgb(h, s, v), 0.0, 1.0)


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize via PIL (torchvision T.Resize semantics)."""
    from PIL import Image
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.resize((size, size), Image.BILINEAR)
    return to_float(pil)


class ImageTransform:
    """Composable pipeline mirroring BaseIMDataset.transforms."""

    def __init__(self, random_h_flip: bool = False, color_jitter: bool = False,
                 normalize: bool = False, resize_to: Optional[int] = None,
                 brightness: float = 0.3, saturation: float = 0.5,
                 hue: float = 0.5):
        self.random_h_flip = random_h_flip
        self.color_jitter = color_jitter
        self.normalize = normalize  # identity — kept for flag parity
        self.resize_to = resize_to
        self.brightness = brightness
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        rng = rng or np.random.default_rng()
        img = to_float(img)
        if self.random_h_flip and rng.random() < 0.5:
            img = hflip(img)
        if self.color_jitter:
            # torchvision applies the enabled jitters in random order
            ops = []
            b = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
            s = rng.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
            h = rng.uniform(-self.hue, self.hue)
            ops = [lambda x: adjust_brightness(x, b),
                   lambda x: adjust_saturation(x, s),
                   lambda x: adjust_hue(x, h)]
            for i in rng.permutation(3):
                img = ops[i](img)
        if self.resize_to is not None and img.shape[0] != self.resize_to:
            img = resize(img, self.resize_to)
        return img
