"""The work of the int8 trunk (I1) counted from its shapes, and the card's
int8 peak.

Each trunk conv with 8 or more input channels (every one after the stem) is
an int8 conv of C to D channels over N x H x W pixels: 2 * N * H * W * 9 * C
* D integer operations, and its bytes are the bf16 x read once (its
quantization happens in the operand load), the int8 weight read once and
the bf16 y written once. Its least time is the larger of its operations at
the int8 peak and its bytes at HBM bandwidth.
"""

from __future__ import annotations

from typing import List, Sequence

from benchmark.lib.counts import BF16, Conv, trunk_convs
from benchmark.lib.peaks import HBM_BYTES

# dense int8 tensor-core operations a second of one H100 SXM at 700 W, no
# sparsity (NVIDIA H100 Tensor Core GPU datasheet)
INT8_OPS = 1979e12
INT8_MIN_CHANNELS = 8  # a trunk conv with fewer inputs (the stem) is not int8


def int8_convs(stages: Sequence[Sequence[int]], n: int, h: int, w: int
               ) -> List[Conv]:
    return [c for c in trunk_convs(stages, n, h, w) if c.c >= INT8_MIN_CHANNELS]


def int8_bytes(c: Conv) -> float:
    return c.act_bytes(c.c) + 9 * c.c * c.d + c.act_bytes(c.d)


def int8_bound_s(stages, n: int, h: int, w: int) -> float:
    """The least time of one forward's int8 convs over n frames, each launch
    bounded alone and summed."""
    return sum(max(c.flops / INT8_OPS, int8_bytes(c) / HBM_BYTES)
               for c in int8_convs(stages, n, h, w))
