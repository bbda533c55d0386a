"""Per-frame inference and PNG output.

Counterpart of ``osvos_tpu/evaluation/infer.py``. Frames go through the
model in fixed-size batches (the trailing batch padded by repeating its last
frame), the sigmoid and the uint8 cast happen on the device, and only the
(N, H, W) uint8 maps come back to the host. Each map is written as one
8-bit grayscale PNG of the continuous probability (sigmoid * 255), not a
thresholded mask; DAVIS binarizes when it evaluates.

The PNGs are written by ``data/image_io``, so the port needs no OpenCV.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from osvos_torch.configs import ModelConfig
from osvos_torch.data.image_io import write_png_gray
from osvos_torch.models.vgg_osvos import OSVOS
from osvos_torch.ops.kernels.fused_head import fused_upsample_sigmoid_u8

InferFn = Callable[[OSVOS, torch.Tensor], torch.Tensor]


def make_infer_fn(model_config: ModelConfig, fused_head: bool = True,
                  kernel_tail: Optional[bool] = None) -> InferFn:
    """``(model, images (N, H, W, 3)) -> (N, H, W) uint8`` on the images'
    device.

    fused_head=True runs the collapsed head (``mode='infer'``);
    fused_head=False the reference-ordered graph (``mode='train'``).
    kernel_tail: take ``mode='infer_parts'`` and finish with the fused tail
    (``ops/kernels/fused_head.py``), which on the card is the CUDA kernel.
    The default is on for CUDA images and off for CPU images.
    """
    factors = [2 ** i for i in range(1, len(model_config.stages))]

    @torch.inference_mode()
    def infer(model: OSVOS, images: torch.Tensor) -> torch.Tensor:
        tail = images.is_cuda if kernel_tail is None else kernel_tail
        if fused_head and tail:
            *contribs, bias = model(images, mode="infer_parts")
            return fused_upsample_sigmoid_u8(
                [c[..., 0].contiguous() for c in contribs], bias,
                out_hw=(images.shape[1], images.shape[2]), factors=factors)
        logits = model(images, mode="infer" if fused_head else "train")[-1]
        probs = torch.sigmoid(logits[..., 0])
        return torch.round(255.0 * probs).to(torch.uint8)

    return infer


def infer_sequence(model: OSVOS, frames: Sequence[np.ndarray],
                   batch_size: int = 4,
                   infer_fn: Optional[InferFn] = None) -> List[np.ndarray]:
    """Run ``model`` over preprocessed (H, W, 3) frames on the model's device;
    returns one (H, W) uint8 map per frame.

    The trailing batch is padded to ``batch_size`` by repeating its last
    frame, so every call sees one batch shape.
    """
    infer = infer_fn if infer_fn is not None else make_infer_fn(model.config)
    device = next(model.parameters()).device
    out: List[np.ndarray] = []
    for start in range(0, len(frames), batch_size):
        chunk = list(frames[start:start + batch_size])
        pad = batch_size - len(chunk)
        chunk += [chunk[-1]] * pad
        batch = torch.from_numpy(np.stack(chunk).astype(np.float32, copy=False))
        masks = infer(model, batch.to(device)).cpu().numpy()
        out.extend(masks[:batch_size - pad])
    return out


def save_mask_png(mask_u8: np.ndarray, path: str) -> None:
    """Write the probability map as a grayscale PNG."""
    write_png_gray(path, mask_u8)


def save_sequence_results(masks: Sequence[np.ndarray], fnames: Sequence[str],
                          results_dir: str, seq_name: str) -> None:
    """The reference layout: ``<results_dir>/<seq>/<frame stem>.png``."""
    for mask, fname in zip(masks, fnames):
        stem = os.path.splitext(os.path.basename(fname))[0]
        save_mask_png(mask, os.path.join(results_dir, seq_name, f"{stem}.png"))
