"""Small image and array helpers.

Counterpart of ``osvos_tpu/data/helpers.py`` (reference:
``dataloaders/helpers.py``), the same functions on numpy arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def tens2image(arr: np.ndarray) -> np.ndarray:
    """Squeeze a (1, H, W, C) or (H, W, C) array to an (H, W[, C]) image."""
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    return a


def im_normalize(im: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]; a constant image becomes zeros."""
    im = np.asarray(im, np.float64)
    lo, hi = im.min(), im.max()
    if hi - lo < 1e-12:
        return np.zeros_like(im)
    return (im - lo) / (hi - lo)


def overlay_mask(im: np.ndarray, ma: np.ndarray, color=(255, 0, 0),
                 alpha: float = 0.5) -> np.ndarray:
    """Blend ``color`` over the pixels where ``ma`` > 0.5 of an HWC image
    in [0, 255]; returns uint8."""
    im = np.asarray(im, np.float32).copy()
    ma = np.asarray(ma) > 0.5
    overlay = np.zeros_like(im)
    overlay[..., :3] = np.asarray(color, np.float32)
    im[ma] = (1 - alpha) * im[ma] + alpha * overlay[ma]
    return im.astype(np.uint8)


def construct_name(p: Mapping, prefix: str) -> str:
    """Encode a hyperparameter dict into a model filename,
    ``prefix_k1-v1_k2-v2`` with the keys sorted."""
    name = prefix
    for k in sorted(p):
        name += f"_{k}-{p[k]}"
    return name
