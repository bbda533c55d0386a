"""OSVOS VGG-16 int8 serving in plain PyTorch: the reference of the int8
cells.

Written from the configuration's stated semantics (``osvos_vgg16_int8``'s
``precision`` and ``calibration``; the port's ``ModelConfig`` names the same
int8 mode), not from the program:
- calibration: a float32 trunk runs over a sequence's first frame, and the
  largest |input| of each trunk conv, times the margin, is that conv's
  static scale s;
- the int8 conv, at every trunk conv with 8 or more input channels (all
  after the stem): x_q = clamp(round(x / (s / 127)), -127, 127), rounding
  half to even; per output channel d the weight scale w_s[d] = max|w[d]| /
  127 and w_q = clamp(round(w / w_s), -127, 127); the integer products
  summed exactly, then times (s / 127) * w_s[d], plus the bias; the ReLU
  follows as at every trunk conv;
- everything else is ``osvos.forward`` in float32 with TF32 off: the stem,
  the side convs, the pools, the upsampling and the fuse.

The sums are exact: float64 sums of integer-valued products, one matrix
product a tap, whose partial sums stay far below 2 ** 53 (|x_q w_q| <= 127 **
2, 9 x 512 terms). ``levels`` other than 127 gives the same reference on
fewer codes (63: int7), the control of the int8 cells.

Departures from the program, which the cells' limits allow for: the
program's trunk activations are bf16 before they are quantized, and its int8
conv writes bf16; its stem and side convs run on bf16 operands with the
bias added in bf16; its calibration runs a bf16 trunk. The scales here are
float64, the program's float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import osvos

LEVELS = 127  # int8: the codes -127..127
MIN_CHANNELS = 8  # trunk convs with fewer inputs (the stem) stay float32


def trunk_names(stages: Sequence[Sequence[int]]) -> List[str]:
    return [f"stage{i + 1}_conv{j}" for i, widths in enumerate(stages)
            for j in range(len(widths))]


class _Recorder:
    """A conv hook that records the largest |input| of each trunk conv."""

    def __init__(self, p: osvos.Params, stages):
        self.index = {id(p[f"{n}.weight"]): k
                      for k, n in enumerate(trunk_names(stages))}
        self.maxes = torch.zeros(len(self.index), dtype=torch.float64)

    def __call__(self, x, w, b):
        k = self.index.get(id(w))
        if k is not None:
            self.maxes[k] = max(float(self.maxes[k]), float(x.abs().max()))
        return osvos.f32_conv(x, w, b)


@torch.no_grad()
def calibrate(p: osvos.Params, frames: torch.Tensor, stages,
              margin: float) -> torch.Tensor:
    """(n_trunk_convs,) float64 static scales: the largest |input| of each
    trunk conv over NHWC ``frames``, float32 trunk, times ``margin``."""
    record = _Recorder(p, stages)
    with osvos.exact_f32():
        osvos.forward(p, frames.permute(0, 3, 1, 2).float(), stages, record)
    return record.maxes * margin


def quantize(t: torch.Tensor, scale: torch.Tensor, levels: int) -> torch.Tensor:
    """clamp(round(t / scale), -levels, levels) in float64, half to even."""
    return torch.round(t.double() / scale).clamp_(-levels, levels)


def int_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: float,
             levels: int = LEVELS) -> torch.Tensor:
    """The int8 conv (before the ReLU) of NCHW float32 x on the static scale
    ``s``, float32 out: each tap's integer product as a float64 matrix
    product, summed exactly."""
    x_s = s / levels
    w_s = w.double().abs().amax((1, 2, 3)) / levels
    w_s = torch.where(w_s > 0, w_s, torch.ones_like(w_s))
    x_q = F.pad(quantize(x, x_s, levels), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    w_q = quantize(w, w_s[:, None, None, None], levels)
    n, h, wd = x.shape[0], x.shape[2], x.shape[3]
    acc = torch.zeros((n, h, wd, w.shape[0]), dtype=torch.float64,
                      device=x.device)
    for kh in range(3):
        for kw in range(3):
            acc += x_q[:, kh:kh + h, kw:kw + wd] @ w_q[:, :, kh, kw].t()
    y = acc * (x_s * w_s) + b.double()
    return y.permute(0, 3, 1, 2).float()


def int8_at(stages) -> List[bool]:
    """Whether each trunk conv is an int8 conv: 8 or more input channels."""
    widths = [d for s in stages for d in s]
    return [c >= MIN_CHANNELS for c in [3] + widths[:-1]]


class Int8Conv:
    """The conv hook of ``osvos.forward`` for one sequence's parameters
    ``p``: keyed on the weight, each trunk conv with 8 or more inputs is
    the int8 conv on its static scale; the stem and the side convs stay
    float32."""

    def __init__(self, p: osvos.Params, stages, scales: torch.Tensor,
                 levels: int = LEVELS):
        self.levels = levels
        self.scale: Dict[int, float] = {
            id(p[f"{name}.weight"]): float(scales[k])
            for k, (name, q) in enumerate(zip(trunk_names(stages), int8_at(stages)))
            if q}

    def __call__(self, x, w, b):
        s = self.scale.get(id(w))
        if s is None:
            return osvos.f32_conv(x, w, b)
        return int_conv(x, w, b, s, self.levels)


def maps_u8(p: osvos.Params, frames: torch.Tensor, stages, scales: torch.Tensor,
            levels: int = LEVELS, batch: int = 4) -> torch.Tensor:
    """(N, H, W) uint8 maps of NHWC ``frames``: ``osvos.maps_u8`` with the
    int8 convs on ``levels`` codes either side of zero, on the static
    ``scales``."""
    return osvos.maps_u8(p, frames, stages, Int8Conv(p, stages, scales, levels),
                         batch)
