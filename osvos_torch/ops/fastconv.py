"""3x3 SAME convolution of the fast-mode trunk, with the JAX package's
backward.

Counterpart of ``osvos_tpu/ops/fastconv.py:conv3x3_same``:

- forward: the bf16 SAME conv of NHWC ``x`` with the float32 OIHW weight
  cast to bf16;
- d(input): the conv of the cotangent with the flipped, channel-transposed
  kernel, in bf16 (``conv_transpose2d`` with the same weight);
- d(weight): ``ops/kernels/wgrad.wgrad3x3`` in float32, the bf16 products
  summed in float32 and kept in float32; for an input of at most three
  channels (the stem) the tap-stacked ``ops/kernels/stem_wgrad.stem_wgrad``,
  whose bias gradient goes unused here. Autograd through a bf16 cast of the
  weight would round this gradient to bf16, which the JAX package does not.

On CUDA tensors the weight gradient is the hand-written kernel B17, or B16
for the stem; on CPU tensors their plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels import stem_wgrad as _stem
from osvos_torch.ops.kernels import wgrad as _wgrad


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose2d(g.permute(0, 3, 1, 2), weight.to(x.dtype),
                                    padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            if x.shape[-1] <= _stem.MAX_C:
                dk, _ = _stem.stem_wgrad(x.contiguous(), g.contiguous())
            else:
                dk = _wgrad.wgrad3x3(x.contiguous(), g.contiguous())  # (3,3,C,D)
            dw = dk.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, C) bf16; weight: (D, C, 3, 3) float32, cast to x's dtype.
    Returns (N, H, W, D) in x's dtype."""
    return _Conv3x3Same.apply(x, weight)
