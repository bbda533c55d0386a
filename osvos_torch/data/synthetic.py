"""Synthetic DAVIS-like frames, numpy only: a DAVIS-layout tree on disk and
an in-memory dataset.

Counterpart of ``osvos_tpu/data/synthetic.py``: a moving, slowly deforming
ellipse over a textured background, made from a seed. ``generate`` writes
the tree the DAVIS reader expects (``JPEGImages/480p/<seq>/NNNNN.jpg``,
``Annotations/480p/<seq>/NNNNN.png``, ``train_seqs.txt`` /
``val_seqs.txt``) with the same sequence names, frames and split files as
the JAX package's, through ``data/image_io`` instead of OpenCV (baseline
4:2:0 JPEG at quality 95, OpenCV's default; the JPEG bytes differ from
OpenCV's, the masks' PNGs decode to the same values). ``SyntheticDAVIS``
keeps frames in memory.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from osvos_torch.configs import MEANVAL_BGR
from osvos_torch.data.image_io import write_jpeg, write_png_gray

DEFAULT_TRAIN_SEQS = ["synth-train-a", "synth-train-b"]
DEFAULT_VAL_SEQS = ["synth-val-a", "synth-val-b"]


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


def generate(root: str, height: int = 96, width: int = 160,
             n_frames: int = 8, train_seqs: Optional[List[str]] = None,
             val_seqs: Optional[List[str]] = None) -> str:
    """Write a synthetic DAVIS-2016 tree under ``root`` and return it."""
    train_seqs = train_seqs if train_seqs is not None else DEFAULT_TRAIN_SEQS
    val_seqs = val_seqs if val_seqs is not None else DEFAULT_VAL_SEQS
    os.makedirs(root, exist_ok=True)
    for split, seqs in (("train_seqs.txt", train_seqs),
                        ("val_seqs.txt", val_seqs)):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(seqs) + "\n")
    for si, seq in enumerate(train_seqs + val_seqs):
        img_dir = os.path.join(root, "JPEGImages", "480p", seq)
        ann_dir = os.path.join(root, "Annotations", "480p", seq)
        for fi in range(n_frames):
            img, mask = _frame(height, width, t=fi * 0.35, seed=si * 11 + 2)
            write_jpeg(os.path.join(img_dir, f"{fi:05d}.jpg"), img)
            write_png_gray(os.path.join(ann_dir, f"{fi:05d}.png"), mask)
    return root


def image_like(n: int, h: int, w: int, seed0: int = 0) -> np.ndarray:
    """(n, h, w, 3) float32 frames preprocessed as ``bench.py`` does for its
    synthetic frames: channels reversed, the caffe BGR mean subtracted."""
    frames = [_frame(h, w, t=0.7 * i, seed=seed0 + i)[0] for i in range(n)]
    arr = np.stack(frames).astype(np.float32)
    return np.ascontiguousarray(arr[..., ::-1] - np.asarray(MEANVAL_BGR,
                                                            np.float32))


class SyntheticDAVIS:
    """An in-memory stand-in for ``DAVIS2016``: ``n`` synthetic (frame,
    mask) pairs of ``size`` = (H, W). ``__getitem__`` returns what
    ``DAVIS2016.__getitem__`` does, ``{'image': BGR minus the caffe mean,
    (H, W, 3) float32; 'gt': (H, W) float32 in {0, 1}; 'fname'}``, passed
    through ``transform``. The train and val splits draw from disjoint
    seeds."""

    VAL_SEED = 1000  # the val split's first seed, past any train split

    def __init__(self, n: int, size: Tuple[int, int] = (480, 854),
                 train: bool = True, transform: Optional[Callable] = None,
                 seed: int = 0):
        self.size = size
        self.train = train
        self.transform = transform
        self.seed0 = seed + (0 if train else self.VAL_SEED)
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, object]:
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        img, mask = _frame(*self.size, t=0.7 * idx, seed=self.seed0 + idx)
        image = (img[..., ::-1].astype(np.float32)
                 - np.asarray(MEANVAL_BGR, np.float32))
        sample: Dict[str, object] = {
            "image": np.ascontiguousarray(image),
            "gt": (mask > 0).astype(np.float32),
            "fname": f"synth-{'train' if self.train else 'val'}/{idx:05d}"}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
