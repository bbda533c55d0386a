"""Ceil-mode max pooling, forward only.

The reference pools with ``MaxPool2d(2, stride=2, ceil_mode=True)``, so odd
extents keep their last row and column (854 -> 427 -> 214 -> 107 -> 54 on
DAVIS 480p). PyTorch has that mode natively; its output sizing is the rule
of ``osvos_tpu/ops/pool.py:_ceil_pad`` (a trailing window exists iff it
starts inside the input). The backward with the row-major-first tie routing
of ``osvos_tpu/ops/pool.py:_mp_bwd`` comes with the online fine-tune.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 stride-2 max pool with ceil-mode output sizing.

    The NCHW view of a contiguous NHWC tensor is channels_last, which the
    pooling kernels take without a copy.
    """
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)
