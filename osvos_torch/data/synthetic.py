"""Synthetic DAVIS-like frames, numpy only.

Counterpart of ``osvos_tpu/data/synthetic.py:_frame``: a moving, slowly
deforming ellipse over a textured background, made from a seed. The JAX
package's module also writes JPEG/PNG trees with OpenCV; the port needs only
the frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from osvos_torch.configs import MEANVAL_BGR


def _frame(h: int, w: int, t: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(image (h, w, 3) uint8, mask (h, w) uint8 in {0, 255}) at time t."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = (96 + 48 * np.sin(xx / (9 + seed % 5) + t)
          + 32 * np.cos(yy / (7 + seed % 3)))
    img = np.stack([bg, np.roll(bg, 3, 0), np.roll(bg, 5, 1)], -1)
    img += rng.randn(h, w, 3) * 4
    cy = h * (0.4 + 0.18 * np.sin(t + seed))
    cx = w * (0.4 + 0.22 * np.cos(0.8 * t + seed))
    ry = h * (0.16 + 0.03 * np.sin(2 * t))
    rx = w * (0.12 + 0.03 * np.cos(1.5 * t))
    mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
    obj = np.stack([200 + 25 * np.sin(yy / 5 + 3 * t),
                    60 + 20 * np.cos(xx / 6),
                    140 + 30 * np.sin((xx + yy) / 8)], -1)
    img = np.where(mask[..., None], obj, img)
    return np.clip(img, 0, 255).astype(np.uint8), mask.astype(np.uint8) * 255


def image_like(n: int, h: int, w: int, seed0: int = 0) -> np.ndarray:
    """(n, h, w, 3) float32 frames preprocessed as ``bench.py`` does for its
    synthetic frames: channels reversed, the caffe BGR mean subtracted."""
    frames = [_frame(h, w, t=0.7 * i, seed=seed0 + i)[0] for i in range(n)]
    arr = np.stack(frames).astype(np.float32)
    return np.ascontiguousarray(arr[..., ::-1] - np.asarray(MEANVAL_BGR,
                                                            np.float32))
