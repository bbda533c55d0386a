"""Class-balanced binary cross-entropy over logits.

Counterpart of ``osvos_tpu/ops/loss.py``. With z = 1{label >= 0.5},
n_pos = sum(z), n_neg = sum(1 - z) and n = n_pos + n_neg, the loss is

    L = (n_neg / n) * sum_pos softplus(-x) + (n_pos / n) * sum_neg softplus(x)

(-log sigmoid(x) = softplus(-x)): each class's summed cross-entropy is
weighted by the other class's share of pixels. Everything is computed in
float32 whatever the input dtype. softplus is the stable form
max(v, 0) + log1p(exp(-|v|)); on the plain route it is ``-logsigmoid(-v)``,
which PyTorch computes in that form and differentiates exactly.

``impl`` names the route, with the JAX package's values: 'xla' is the plain
PyTorch expression under autograd; 'pallas' is the route through the
hand-written CUDA kernels of ``ops/kernels/cbbce.py``, the counterpart of
the Pallas kernels of ``osvos_tpu/ops/pallas/cbbce.py`` (one pass over the
logits for the statistics, one for the gradient). On CPU tensors the
'pallas' route runs the kernels' plain versions through the same
``autograd.Function``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels import cbbce as _cbbce

IMPLS = ("xla", "pallas")


def _balanced(stats: torch.Tensor) -> torch.Tensor:
    """Per-sample loss from (B, 4) statistics."""
    num_pos, num_neg, sum_pos, sum_neg = stats.unbind(1)
    total = num_pos + num_neg
    return num_neg / total * sum_pos + num_pos / total * sum_neg


class _KernelLoss(torch.autograd.Function):
    """(B,) losses of (B, n) float32 logits and labels, divided by ``norm``,
    through ``cbbce_stats`` forward and ``cbbce_grad`` backward."""

    @staticmethod
    def forward(ctx, logits, labels, norm: float):
        stats = _cbbce.cbbce_stats(logits, labels)
        ctx.save_for_backward(logits, labels, stats)
        ctx.norm = norm
        return _balanced(stats) / norm

    @staticmethod
    def backward(ctx, g):
        logits, labels, stats = ctx.saved_tensors
        num_pos, num_neg = stats[:, 0], stats[:, 1]
        total = num_pos + num_neg
        weights = torch.stack([num_neg / total, num_pos / total,
                               g.float() / ctx.norm, torch.zeros_like(total)],
                              dim=1)
        return _cbbce.cbbce_grad(logits, labels, weights), None, None


def _rows(t: torch.Tensor, b: int) -> torch.Tensor:
    return t.reshape(b, -1).float().contiguous()


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _plain_terms(logits: torch.Tensor, labels: torch.Tensor, dims):
    x = logits.float()
    z = (labels.float() >= 0.5).float()
    num_pos = z.sum(dims)
    num_neg = (1.0 - z).sum(dims)
    loss_pos = (z * -F.logsigmoid(x)).sum(dims)
    loss_neg = ((1.0 - z) * -F.logsigmoid(-x)).sum(dims)
    total = num_pos + num_neg
    return num_neg / total * loss_pos + num_pos / total * loss_neg


def class_balanced_cross_entropy_loss(output: torch.Tensor, label: torch.Tensor,
                                      size_average: bool = False,
                                      batch_average: bool = True,
                                      impl: str = "xla") -> torch.Tensor:
    """Class-balanced BCE of logits of any shape (NHWC here), one class
    balance over the whole batch; divided by the element count
    (``size_average``) or else by the batch size (``batch_average``)."""
    _check_impl(impl)
    norm = 1.0
    if size_average:
        norm = float(label.numel())
    elif batch_average:
        norm = float(label.shape[0])
    if impl == "pallas":
        return _KernelLoss.apply(_rows(output, 1), _rows(label, 1), norm)[0]
    return _plain_terms(output, label, tuple(range(output.dim()))) / norm


def class_balanced_cross_entropy_loss_per_sample(
        output: torch.Tensor, label: torch.Tensor,
        impl: str = "xla") -> torch.Tensor:
    """(B,) per-sample class-balanced BCE: entry b equals
    ``class_balanced_cross_entropy_loss(output[b:b+1], label[b:b+1])``.
    Its mean over a batch of n is the reference's accumulated
    ``loss / nAveGrad`` over n single samples."""
    _check_impl(impl)
    b = output.shape[0]
    if impl == "pallas":
        return _KernelLoss.apply(_rows(output, b), _rows(label, b), 1.0)
    return _plain_terms(output, label, tuple(range(1, output.dim())))


def class_balanced_cross_entropy_loss_theoretical(
        output: torch.Tensor, label: torch.Tensor,
        eps: float = 1e-20) -> torch.Tensor:
    """The reference's textbook variant: sigmoid, then eps-clamped logs,
    with the same class weights. Unstable for large logits; a cross-check
    where logits are moderate."""
    x = output.float()
    z = (label.float() >= 0.5).float()
    num_pos = z.sum()
    num_neg = (1.0 - z).sum()
    total = num_pos + num_neg
    probs = torch.sigmoid(x)
    loss_pos = (-z * torch.log(probs + eps)).sum()
    loss_neg = (-(1.0 - z) * torch.log(1.0 - probs + eps)).sum()
    return num_neg / total * loss_pos + num_pos / total * loss_neg
