"""The control of the training cells: the reference computed one precision
below the configuration's.

The configurations state a bf16 trunk (its convs' operands in bf16, float32
sums). The control runs the trunk and side convs on int8 operands, each
tensor on its own symmetric scale (max / 127): x and the weight in the
forward, the cotangent and the same x and weight in the backward; the
heads, the upsampling and the loss stay float32. int8 is the step below
bf16 that the port already takes (I1, its int8 inference conv). The fp8
(e4m3) operands the same way were tried first and moved the compared
norms too little against the seeds' own spread (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to int8 under a symmetric per-tensor scale (max / 127),
    back in float32."""
    amax = t.detach().abs().max()
    scale = torch.where(amax > 0, amax / 127, torch.ones_like(amax))
    return torch.round(t / scale).clamp_(-127, 127) * scale


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = int8(x), int8(w)
        ctx.save_for_backward(xq, wq)
        ctx.x_shape, ctx.w_shape = x.shape, w.shape
        return F.conv2d(xq, wq, b, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = int8(g)
        pad = wq.shape[-1] // 2
        dx = torch.nn.grad.conv2d_input(ctx.x_shape, wq, gq, padding=pad)
        dw = torch.nn.grad.conv2d_weight(xq, ctx.w_shape, gq, padding=pad)
        return dx, dw, g.sum((0, 2, 3))


def int8_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 operands forward and backward, each tensor on its own scale."""
    return _Int8Conv.apply(x, w, b)
