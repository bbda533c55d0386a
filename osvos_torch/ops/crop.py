"""Center crop with the reference's offset convention.

The reference crops with negative ``F.pad`` amounts, ceil/floor of
(target - size) / 2, which removes ``(size - target) // 2`` from the leading
edge. Counterpart of ``osvos_tpu/ops/crop.py``.
"""

from __future__ import annotations

import torch


def center_crop(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Crop NHWC ``x`` to (height, width); returns a view."""
    h, w = x.shape[1], x.shape[2]
    if h == height and w == width:
        return x
    if h < height or w < width:
        raise ValueError(
            f"center_crop: input {(h, w)} smaller than target {(height, width)}")
    top = (h - height) // 2
    left = (w - width) // 2
    return x[:, top:top + height, left:left + width, :]
