"""Ceil-mode max pooling with the reference's tie routing in the backward.

The reference pools with ``MaxPool2d(2, stride=2, ceil_mode=True)``, so odd
extents keep their last row and column (854 -> 427 -> 214 -> 107 -> 54 on
DAVIS 480p). PyTorch has that mode natively; its output sizing is the rule
of ``osvos_tpu/ops/pool.py:_ceil_pad`` (a trailing window exists iff it
starts inside the input).

The backward restates ``osvos_tpu/ops/pool.py:_mp_bwd``: the cotangent of a
window goes to the row-major-first tap that equals the max. PyTorch's own
max-pool backward routes ties through the index its forward kept, which
differs, and bf16 activations tie often.

``max_pool_ceil`` runs the hand-written kernels of ``ops/kernels/pool.py``
(B7-B10) on CUDA tensors and the plain ``pool_fwd``/``pool_bwd`` on CPU
tensors; the flat trunk's plain versions use ``pool_fwd``/``pool_bwd``
directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels import pool as _kernel


def pool_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The cotangent of NHWC ``x`` from the cotangent ``g`` of its pool
    ``y``: each window's to its row-major-first pixel equal to the max."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 0, w % 2, 0, h % 2), value=float("-inf"))
    hp, wp = xp.shape[1], xp.shape[2]
    r = xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
    a, b = r[:, :, 0, :, 0], r[:, :, 0, :, 1]
    cc, d = r[:, :, 1, :, 0], r[:, :, 1, :, 1]
    # a wins ties over b over cc over d
    wa = a == y
    wb = (b == y) & ~wa
    wc = (cc == y) & ~wa & ~wb
    wd = (d == y) & ~wa & ~wb & ~wc
    row0 = torch.stack([torch.where(wa, g, 0.0), torch.where(wb, g, 0.0)], dim=3)
    row1 = torch.stack([torch.where(wc, g, 0.0), torch.where(wd, g, 0.0)], dim=3)
    dx = torch.stack([row0, row1], dim=2).reshape(n, hp, wp, c)
    return dx[:, :h, :w]


def pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """The NHWC pool, contiguous: exact in x's dtype."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


class _MaxPoolCeil(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        y = _kernel.max_pool_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _kernel.max_pool_bwd(x, y, g.to(x.dtype).contiguous())


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 stride-2 max pool with ceil-mode output sizing, and the
    reference's tie routing in its backward."""
    return _MaxPoolCeil.apply(x)
