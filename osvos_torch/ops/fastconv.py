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

``conv3x3_same_seq`` is the same conv for S sequences at once, the packed
schedule's trunk (``parallel/packed.py``): the sequence is folded into the
channels and the conv groups, x (N, H, W, S * C) and a stacked (S, D, C, 3,
3) float32 weight, forward and d(input) grouped library convs
(``groups=S``), dK from the sequence-batched kernels ``wgrad3x3_seq`` or,
for the stem, ``stem_wgrad_seq``: one launch for the S sequences, each
sequence's dK bit for bit the lone kernel's on its slice.

``conv3x3_bias_relu_seq`` is that conv with the fast mode's bias add and
the ReLU after it, relu(bf16(bf16(conv) + b)), for the packed trunk's
convs: on CUDA tensors of the shapes B2-seq takes (every trunk conv after
the stem, ``flatconv.seq_fwd_takes``) the forward is one launch of B2-seq
(``ops/kernels/flatconv.conv_fwd_seq``), the bias and both roundings and
the ReLU in its epilogue, in place of the grouped library conv, the bias
add and the ReLU, three passes over the output; its sums differ from the
library conv's only in order. Elsewhere (the stem, CPU tensors) the
forward is those three operations. The backward runs what autograd runs
through ``conv3x3_same_seq`` + bias + ``F.relu``, the same operations in
the same dtypes and from nodes that hold what autograd's hold: a node on
the output whose backward is ReLU's ``threshold_backward`` and which alone
keeps the output, then the conv's node, which keeps x and the weight and
gives the bias gradient as the masked gradient's bf16 sum over (N, H, W)
(``sum_to_size``, as the add's backward reduces it) and
``conv3x3_same_seq``'s gradients. So given the same output its gradients
are bit for bit those of the three operations, and the output is freed
before the conv's gradients are taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels import flatconv as _flat
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


def _conv_seq(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The grouped library conv of the S sequences, in x's dtype."""
    w = weight.to(x.dtype).flatten(0, 1)  # (S * D, C, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=weight.shape[0])
    return y.permute(0, 2, 3, 1)


def _conv_seq_grads(x, weight, g, need_x: bool, need_w: bool):
    """(dx, dw) of ``conv3x3_same_seq`` for the output's cotangent g,
    None where not needed."""
    s = weight.shape[0]
    g = g.to(x.dtype)
    dx = dw = None
    if need_x:
        dx = F.conv_transpose2d(g.permute(0, 3, 1, 2),
                                weight.to(x.dtype).flatten(0, 1), padding=1,
                                groups=s).permute(0, 2, 3, 1)
    if need_w:
        if x.shape[-1] // s <= _stem.MAX_C:
            dk, _ = _stem.stem_wgrad_seq(x.contiguous(), g.contiguous(), s)
        else:  # (S, 3, 3, C, D)
            dk = _wgrad.wgrad3x3_seq(x.contiguous(), g.contiguous(), s)
        dw = dk.permute(0, 4, 3, 1, 2).to(weight.dtype)
    return dx, dw


class _Conv3x3SameSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _conv_seq(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return _conv_seq_grads(x, weight, g, *ctx.needs_input_grad)


def conv3x3_same_seq(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, S * C) bf16, sequence s in channels [s * C, (s + 1) * C);
    weight: (S, D, C, 3, 3) float32, cast to x's dtype. Returns (N, H, W,
    S * D) in x's dtype, sequence s in channels [s * D, (s + 1) * D)."""
    return _Conv3x3SameSeq.apply(x, weight)


class _Conv3x3BiasReluSeq(torch.autograd.Function):
    """relu(conv + bias); its backward takes the gradient already masked by
    ``_ReluMask``, so this node keeps x and the weight only."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        _, d, c = weight.shape[:3]
        if x.is_cuda and _flat.seq_fwd_takes(*x.shape[:3], c, d):
            return _flat.conv_fwd_seq(x, weight, bias)
        return F.relu(_conv_seq(x, weight) + bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        db = g.sum_to_size(g.shape[-1]) if ctx.needs_input_grad[2] else None
        return (*_conv_seq_grads(x, weight, g, *ctx.needs_input_grad[:2]), db)


class _ReluMask(torch.autograd.Function):
    """The identity on a ReLU's output z, with the ReLU's backward,
    ``threshold_backward(g, z, 0)``: z is kept by this node alone and freed
    once its backward has run, as ``F.relu``'s node frees it."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return z

    @staticmethod
    def backward(ctx, g):
        z, = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(g, z, 0)


def conv3x3_bias_relu_seq(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3_same_seq(x, weight) + bias) of S sequences: x (N, H,
    W, S * C) bf16, weight (S, D, C, 3, 3) float32, bias (S * D,) bf16 (the
    stacked bias flattened and cast, which autograd carries back to the
    float32 parameter). One B2-seq launch on CUDA tensors where
    ``flatconv.seq_fwd_takes`` the shape, the three operations elsewhere
    (module docstring)."""
    return _ReluMask.apply(_Conv3x3BiasReluSeq.apply(x, weight, bias))
