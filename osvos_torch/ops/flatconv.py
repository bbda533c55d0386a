"""The flat trunk's convolutions as autograd functions.

Counterparts of the public ops of ``osvos_tpu/ops/pallas/flatconv.py`` and
the fused ones of ``osvos_tpu/ops/pallas/flatpool.py``, on NHWC bf16 tensors
that hold post-ReLU activations:

- ``flat_conv3x3``: relu(conv(z) + b), the bias added in float32 before the
  one bf16 rounding (``flat_conv3x3`` with relu_input=False,
  relu_output=True). Its backward masks dz by (z > 0), which is the
  producer's ReLU backward, so no consumer pays a ReLU pass;
- ``flat_conv3x3_input``: the same for the image (the stem): no input ReLU,
  and a backward of dK and db only;
- ``conv_pool``: stage 1's last conv with the stage-boundary ceil-mode pool
  in its epilogue, returning the pooled map (``flatpool.packed_conv_pool``,
  here unpacked and for any H, W); its backward routes the pooled cotangent
  (row-major-first ties) inside the conv backward;
- ``flat_side_conv3x3_fl``: the side_prep conv C -> 16, no bias or ReLU,
  bf16 out (stage 5);
- ``side_and_pool_fl``: the side conv and the next stage's pool of the same
  input (stages 2-4); the backward sums the side's masked dz and the routed
  pool cotangent in float32 before the one rounding.

Weights are the float32 OIHW parameters; their gradients are float32. Each
function calls the kernel wrappers of ``ops/kernels/flatconv.py`` (B2-B6),
which run the plain versions on CPU tensors. ``flat_conv3x3_ref`` is the
plain autograd twin (``flatconv.py:flat_conv3x3_ref``), with ``max_pool_ceil``
of ``ops/pool.py`` as its pool.
"""

from __future__ import annotations

from typing import Tuple

import torch

from osvos_torch.ops.kernels import flatconv as _k

BF16 = torch.bfloat16


def _dk(dk: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) -> the OIHW (D, C, 3, 3) gradient of the parameter."""
    return dk.permute(3, 2, 0, 1)


def _ct(g: torch.Tensor) -> torch.Tensor:
    """A cotangent as the kernels take it: contiguous bf16."""
    return g.to(BF16).contiguous()


class _FlatConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, weight, bias):
        y, _ = _k.conv_fwd(z, weight, bias)
        ctx.save_for_backward(z, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        z, weight = ctx.saved_tensors
        dz, dk, db, _ = _k.conv_bwd(z, weight, _ct(g))
        return dz, _dk(dk), db


class _FlatConv3x3Input(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        y, _ = _k.conv_fwd(x, weight, bias)
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dk, db = _k.stem_bwd(x, _ct(g))
        return None, _dk(dk), db


class _ConvPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, weight, bias):
        y, pooled = _k.conv_fwd(z, weight, bias, pool=True)
        ctx.save_for_backward(z, weight, y, pooled)
        return pooled

    @staticmethod
    def backward(ctx, d_pooled):
        z, weight, y, pooled = ctx.saved_tensors
        dz, dk, db, _ = _k.conv_bwd(z, weight,
                                    route=(y, pooled, _ct(d_pooled)))
        return dz, _dk(dk), db


class _SideConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, weight):
        side, _ = _k.side_fwd(z, weight)
        ctx.save_for_backward(z, weight)
        return side

    @staticmethod
    def backward(ctx, g):
        z, weight = ctx.saved_tensors
        dz, dk = _k.side_bwd(z, weight, _ct(g))
        return dz, _dk(dk)


class _SideAndPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, weight):
        side, pooled = _k.side_fwd(z, weight, pool=True)
        ctx.save_for_backward(z, weight, pooled)
        return side, pooled

    @staticmethod
    def backward(ctx, g_side, d_pooled):
        z, weight, pooled = ctx.saved_tensors
        dz, dk = _k.side_bwd(z, weight, _ct(g_side),
                             pool=(pooled, _ct(d_pooled)))
        return dz, _dk(dk)


def flat_conv3x3(z: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """z (N, H, W, C) bf16 post-ReLU; weight (D, C, 3, 3), bias (D,)
    float32. Returns relu(conv(z) + b), (N, H, W, D) bf16."""
    return _FlatConv3x3.apply(z, weight, bias)


def flat_conv3x3_input(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """The stem: ``flat_conv3x3`` of the bf16 image, which is not
    differentiated."""
    return _FlatConv3x3Input.apply(x, weight, bias)


def conv_pool(z: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The ceil-mode 2x2/2 max pool of ``flat_conv3x3(z, weight, bias)``,
    (N, ceil(H/2), ceil(W/2), D) bf16."""
    return _ConvPool.apply(z, weight, bias)


def flat_side_conv3x3_fl(z: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """bf16(conv(z)) of the side_prep weight (D, C, 3, 3), no bias."""
    return _SideConv.apply(z, weight)


def side_and_pool_fl(z: torch.Tensor, weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``flat_side_conv3x3_fl(z, weight)``, the ceil-mode pool of z)."""
    return _SideAndPool.apply(z, weight)


def flat_conv3x3_ref(z: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     relu_output: bool = True) -> torch.Tensor:
    """Plain autograd twin: the float32 conv of z's values with the
    bf16-rounded weight, plus the bias, ReLU'd if ``relu_output``, rounded
    to bf16. Its input gradient carries no (z > 0) mask."""
    y = _k.conv3x3_f32(z, weight) + bias.float()
    return (y.clamp_min(0) if relu_output else y).to(BF16)
