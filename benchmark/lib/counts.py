"""The work of OSVOS VGG-16 counted from its shapes: the same count
whatever implements it.

A 3x3 conv of C to D channels over N x H x W pixels is 2 * N * H * W * 9 * C
* D floating-point operations, and so is each of its input gradient (dx) and
weight gradient (dK). A frame's forward is the trunk's convs and the four
side convs (the 1x1 heads and the fixed upsampling are left out: under a
thousandth of it); a fine-tune step is forward, dK and dx of each of them,
with no dx at the stem, whose input is the image. Bytes count each input
read once and each output written once, at the dtype the path stores them
in (bf16 activations, float32 weight gradients).

Frozen from ``chip_smoke.py`` (``trunk_conv_shapes``, ``bound``), so that a
later change of the program cannot change the yardstick.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

from benchmark.lib.peaks import bound_s

BF16, F32 = 2, 4


class Conv(NamedTuple):
    name: str
    n: int
    h: int
    w: int
    c: int
    d: int

    @property
    def flops(self) -> float:
        return 2.0 * self.n * self.h * self.w * 9 * self.c * self.d

    def act_bytes(self, ch: int) -> float:
        return float(self.n * self.h * self.w * ch * BF16)


def stage_hw(h: int, w: int, n_stages: int) -> List[Tuple[int, int]]:
    """(H, W) of each stage: ceil-mode 2x2/2 pools between stages."""
    out = []
    for _ in range(n_stages):
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def trunk_convs(stages: Sequence[Sequence[int]], n: int, h: int, w: int
                ) -> List[Conv]:
    hw = stage_hw(h, w, len(stages))
    out, c = [], 3
    for i, widths in enumerate(stages):
        for j, d in enumerate(widths):
            out.append(Conv(f"stage{i + 1}_conv{j}", n, *hw[i], c, d))
            c = d
    return out


def side_convs(stages: Sequence[Sequence[int]], side_channels: int, n: int,
               h: int, w: int) -> List[Conv]:
    hw = stage_hw(h, w, len(stages))
    return [Conv(f"side_prep{i}", n, *hw[i], stages[i][-1], side_channels)
            for i in range(1, len(stages))]


def forward_flops(stages, side_channels: int, n: int, h: int, w: int) -> float:
    """Forward operations of n frames: trunk and side convs."""
    return sum(c.flops for c in trunk_convs(stages, n, h, w)
               + side_convs(stages, side_channels, n, h, w))


def step_flops(stages, side_channels: int, n: int, h: int, w: int) -> float:
    """Operations of one training step of batch n: forward, dK and dx of
    every conv, no dx at the stem."""
    stem = trunk_convs(stages, n, h, w)[0]
    return 3 * forward_flops(stages, side_channels, n, h, w) - stem.flops


def _dk_bytes(c: Conv) -> float:
    return c.act_bytes(c.c) + c.act_bytes(c.d) + (9 * c.c + 1) * c.d * F32


def seq_wgrad_bound_s(stages, n: int, h: int, w: int, s: int) -> float:
    """The least time of one packed step's sequence launches: dK (and db at
    the stem) of every trunk conv for ``s`` sequences, each launch bounded
    alone and summed."""
    total = 0.0
    for c in trunk_convs(stages, n, h, w):
        total += bound_s(s * c.flops, s * _dk_bytes(c))
    return total
