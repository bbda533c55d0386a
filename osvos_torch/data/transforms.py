"""Host-side sample transforms of parent training, without OpenCV.

Counterpart of ``osvos_tpu/data/transforms.py`` (reference:
``dataloaders/custom_transforms.py``). Each transform maps a sample dict
``{'image': HWC float32, 'gt': HW(1) float32, ['fname': str]}`` to the same
structure. The draws come from ``rng.random()`` in the JAX package's order
(one for the flip, then the angle and the scale), so one seeded
``random.Random`` gives both packages the same augmentation.

The card's machine has no OpenCV, so the two resampling calls are restated
in numpy on the CPU, as the OpenCV build beside the JAX package computes
them:

- ``cv2.warpAffine`` (``ScaleNRotate``): the matrix of
  ``cv2.getRotationMatrix2D`` is inverted in float64, and each output pixel
  maps to its source point in float32 (``m00*x + (m01*y + m02)``). Bicubic
  (a = -0.75) weights of the source point's fraction, a 4x4 neighbourhood
  whose taps off the image count as zero; nearest-neighbour rounds the point
  to the nearest pixel, zero off the image.
- ``cv2.resize`` (``Resize``): output pixel i samples the source at
  ``(i + 0.5) * scale - 0.5`` in float64, bicubic with edge pixels repeated,
  rows of each output row first; nearest takes ``floor(i * scale)``. The
  same size returns an exact copy. ``resize(..., bilinear=True)`` is
  OpenCV's default ``INTER_LINEAR`` in float32 (the DAVIS reader's
  ``input_res``): the point's fraction in float32, set to 0 where the
  point lies left of the first or right of the last pixel.

Arrays whose every value is 0 or 1 (the masks) take nearest-neighbour
sampling, the others bicubic.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

Sample = Dict[str, object]

_A = -0.75  # OpenCV's bicubic coefficient


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """(..., 4) weights of the taps at -1, 0, 1, 2 for fractions ``t``,
    computed in t's dtype."""
    a = t.dtype.type(_A)
    one = t.dtype.type(1)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + one
    c2 = ((a + 2) * (one - t) - (a + 3)) * (one - t) * (one - t) + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _binary(img: np.ndarray) -> bool:
    return bool(((img == 0) | (img == 1)).all())


def _as_hwc(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32).reshape(img.shape[0], img.shape[1], -1)


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, angle in degrees,
    counter-clockwise about ``center`` = (x, y)."""
    rad = math.radians(angle)
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(img: np.ndarray, m: np.ndarray, nearest: bool) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags)`` with a zero border, for a
    float32 (H, W) or (H, W, C) array; the output has img's shape."""
    h, w = img.shape[:2]
    src = _as_hwc(img)
    inv = _invert_affine(m).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    sy = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
    flat = src.reshape(h * w, -1)
    if nearest:
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = np.clip(iy, 0, h - 1) * w + np.clip(ix, 0, w - 1)
        out = np.where(inside[..., None], flat[idx], np.float32(0))
        return out.reshape(img.shape)
    fx, fy = np.floor(sx), np.floor(sy)
    wx, wy = _cubic_weights(sx - fx), _cubic_weights(sy - fy)
    x0, y0 = fx.astype(np.int64) - 1, fy.astype(np.int64) - 1
    out = np.zeros((h, w, src.shape[2]), np.float32)
    for i in range(4):
        yi = y0 + i
        row_in = (yi >= 0) & (yi < h)
        for j in range(4):
            xj = x0 + j
            inside = row_in & (xj >= 0) & (xj < w)
            idx = np.clip(yi, 0, h - 1) * w + np.clip(xj, 0, w - 1)
            wt = np.where(inside, wy[..., i] * wx[..., j], np.float32(0))
            out += flat[idx] * wt[..., None]
    return out.reshape(img.shape)


def _resize_axis(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (n_out, 4), edges repeated, and float32 bicubic
    weights (n_out, 4) along one axis."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    s = np.floor(f)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                  0, n_in - 1)
    return idx, _cubic_weights(f - s).astype(np.float32)


def _linear_axis(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (n_out, 2) and float32 weights (n_out, 2) of
    ``INTER_LINEAR`` along one axis."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = f - s
    s = s.astype(np.int64)
    frac[(s < 0) | (s >= n_in - 1)] = 0
    s = np.clip(s, 0, n_in - 1)
    idx = np.stack([s, np.minimum(s + 1, n_in - 1)], axis=1)
    return idx, np.stack([np.float32(1) - frac, frac], axis=1)


def resize(img: np.ndarray, size: Tuple[int, int], nearest: bool,
           bilinear: bool = False) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation)`` of a float32 (H, W) or
    (H, W, C) array to ``size`` = (h, w): nearest, bilinear, or else
    bicubic."""
    oh, ow = size
    h, w = img.shape[:2]
    if (oh, ow) == (h, w):
        return np.array(img, np.float32)
    src = _as_hwc(img)
    if bilinear and not nearest:
        iy, wy = _linear_axis(h, oh)
        ix, wx = _linear_axis(w, ow)
        rows = (src[:, ix[:, 0]] * wx[None, :, 0, None]
                + src[:, ix[:, 1]] * wx[None, :, 1, None])
        out = (rows[iy[:, 0]] * wy[:, 0, None, None]
               + rows[iy[:, 1]] * wy[:, 1, None, None])
    elif nearest:
        ry = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
        rx = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
        out = src[ry.astype(np.int64)][:, rx.astype(np.int64)]
    else:
        iy, wy = _resize_axis(h, oh)
        ix, wx = _resize_axis(w, ow)
        rows = np.zeros((h, ow, src.shape[2]), np.float32)
        for k in range(4):
            rows += src[:, ix[:, k]] * wx[None, :, k, None]
        out = np.zeros((oh, ow, src.shape[2]), np.float32)
        for k in range(4):
            out += rows[iy[:, k]] * wy[:, k, None, None]
    return out.reshape((oh, ow) + img.shape[2:])


class Compose:
    def __init__(self, transforms: Sequence[Callable[[Sample], Sample]]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


class RandomHorizontalFlip:
    """Flip image and gt together with probability p (one draw)."""

    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < self.p:
            for k, v in sample.items():
                if k != "fname":
                    sample[k] = np.ascontiguousarray(np.asarray(v)[:, ::-1])
        return sample


def scale_n_rotate(img: np.ndarray, rot: float, sc: float) -> np.ndarray:
    """One ScaleNRotate warp of a float32 array about its centre: nearest
    for a 0/1 array, bicubic otherwise, zero border."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = rotation_matrix((w / 2, h / 2), rot, sc)
    return warp_affine(img, m, nearest=_binary(img))


class ScaleNRotate:
    """Rotation (degrees) and scale about the image centre: rot ~ U(rots),
    then sc ~ U(scales); bicubic for images, nearest for 0/1 gts, zero
    border."""

    def __init__(self, rots: Tuple[float, float] = (-30, 30),
                 scales: Tuple[float, float] = (0.75, 1.25),
                 rng: Optional[random.Random] = None):
        self.rots = rots
        self.scales = scales
        self.rng = rng or random

    def draw(self) -> Tuple[float, float]:
        """The next (rot, sc) of the generator."""
        rot = self.rots[0] + self.rng.random() * (self.rots[1] - self.rots[0])
        sc = self.scales[0] + self.rng.random() * (self.scales[1] - self.scales[0])
        return rot, sc

    def __call__(self, sample: Sample) -> Sample:
        rot, sc = self.draw()
        for k, v in sample.items():
            if k != "fname":
                sample[k] = scale_n_rotate(v, rot, sc)
        return sample


class Resize:
    """Resize to a fixed (H, W); bicubic for images, nearest for 0/1 gts."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size  # (H, W)

    def __call__(self, sample: Sample) -> Sample:
        for k, v in sample.items():
            if k == "fname":
                continue
            img = np.asarray(v, np.float32)
            sample[k] = resize(img, self.size, nearest=_binary(img))
        return sample


class ToArray:
    """Finalize to NHWC-ready float32 arrays; gts gain a channel dim."""

    def __call__(self, sample: Sample) -> Sample:
        for k, v in sample.items():
            if k == "fname":
                continue
            arr = np.asarray(v, np.float32)
            if arr.ndim == 2:
                arr = arr[..., None]
            sample[k] = np.ascontiguousarray(arr)
        return sample
