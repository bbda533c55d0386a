"""OSVOS VGG-16 in plain PyTorch, float32: the reference that decides
``correct``.

Written from the published model (Caelles, Maninis et al., CVPR 2017,
arXiv:1611.05198; OSVOS-PyTorch's ``vgg_osvos.py``, ``layers/osvos_layers.py``
and ``train_online.py``), not from the program: a VGG-16 trunk of 3x3 convs
and ReLUs in five stages with ceil-mode 2x2/2 max pools between them; for
stages 2-5 a 3x3 side conv to 16 channels, upsampled by a fixed bilinear
transposed conv (kernel 2f, stride f, f = 2 ** i) and centre-cropped to the
frame (``center_crop``: (size - target) // 2 off the leading edge); the
four side maps concatenated and fused by a 1x1 conv to one logit map. The
fine-tune's loss is the class-balanced BCE of the fused logits, a sample's
each, meaned over the batch; its optimizer SGD with momentum 0.9 over
the published parameter groups.

Tensors are NCHW float32; parameters are a dict of OIHW weights and biases
named as ``lib/inputs.param_shapes`` names them. Everything runs with TF32
off. ``conv`` may be replaced (``reference/control.py``) to compute the
trunk and side convs in a lower precision: the control.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Conv = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def f32_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convs with TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bilinear_kernel(size: int, device) -> torch.Tensor:
    """OSVOS's ``upsample_filt``: the (size, size) bilinear kernel."""
    factor = (size + 1) // 2
    center = factor - 1.0 if size % 2 == 1 else factor - 0.5
    og = torch.arange(size, dtype=torch.float64, device=device)
    tent = 1 - (og - center).abs() / factor
    return (tent[:, None] * tent[None, :]).float()


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The frozen ConvTranspose2d(C, C, 2f, stride=f) with the bilinear
    kernel on the channel diagonal (``interp_surgery``), as a depthwise
    transposed conv."""
    c, k = x.shape[1], 2 * factor
    w = bilinear_kernel(k, x.device).expand(c, 1, k, k).contiguous()
    return F.conv_transpose2d(x, w, stride=factor, groups=c)


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    top, left = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    return x[:, :, top:top + h, left:left + w]


def forward(p: Params, x: torch.Tensor, stages: Sequence[Sequence[int]],
            conv: Conv = f32_conv) -> torch.Tensor:
    """The fused logits (N, 1, H, W) of frames x (N, 3, H, W)."""
    h_out, w_out = x.shape[2], x.shape[3]
    sides = []
    h = x
    for i, widths in enumerate(stages):
        if i:
            h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        for j in range(len(widths)):
            name = f"stage{i + 1}_conv{j}"
            h = F.relu(conv(h, p[f"{name}.weight"], p[f"{name}.bias"]))
        if i:
            side = conv(h, p[f"side_prep{i}.weight"], p[f"side_prep{i}.bias"])
            sides.append(center_crop(upsample(side, 2 ** i), h_out, w_out))
    return F.conv2d(torch.cat(sides, dim=1), p["fuse.weight"], p["fuse.bias"])


def cbbce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N,) class-balanced BCE of (N, 1, H, W) logits: each class's summed
    cross-entropy weighted by the other class's share of the sample's
    pixels (labels >= 0.5 are the object)."""
    dims = tuple(range(1, logits.dim()))
    z = (labels >= 0.5).float()
    n_pos, n_neg = z.sum(dims), (1 - z).sum(dims)
    loss_pos = (z * F.softplus(-logits)).sum(dims)
    loss_neg = ((1 - z) * F.softplus(logits)).sum(dims)
    total = n_pos + n_neg
    return n_neg / total * loss_pos + n_pos / total * loss_neg


def group(name: str) -> Tuple[float, bool]:
    """(lr multiplier, weight decay?) of a parameter in OSVOS-PyTorch's
    ``train_online.py`` groups: trunk and side weights x1 with decay, their
    biases x2 without; score_dsn x0.1 / x0.2; fuse x0.01 / x0.02."""
    module, leaf = name.split(".")
    weight = leaf == "weight"
    if module.startswith(("stage", "side_prep")):
        mult = 1.0
    elif module.startswith("score_dsn"):
        mult = 0.1
    elif module == "fuse":
        mult = 0.01
    else:
        raise ValueError(f"no group for {name}")
    return (mult if weight else 2 * mult), weight


class Trainer:
    """The one-shot fine-tune's steps: batch-mean CB-BCE of the fused
    output, then SGD (dampening 0): d = g + wd * p on decayed leaves,
    buf = d on the first step and momentum * buf + d after, p -= lr * buf.
    Leaves outside the fused output's graph (score_dsn) get a zero
    gradient and still decay, as in the published optimizer."""

    def __init__(self, params: Params, stages, lr: float, momentum: float,
                 weight_decay: float, conv: Conv = f32_conv):
        self.p = {k: v.detach().clone().float() for k, v in params.items()}
        self.stages, self.conv = stages, conv
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.buf: Params = {}

    def step(self, images: torch.Tensor, masks: torch.Tensor
             ) -> Tuple[torch.Tensor, Params]:
        """One step on NHWC images and masks; returns (loss, gradient)."""
        leaves = {k: v.requires_grad_(True) for k, v in self.p.items()}
        with exact_f32():
            logits = forward(leaves, images.permute(0, 3, 1, 2).float(),
                             self.stages, self.conv)
            loss = cbbce_per_sample(logits, masks.permute(0, 3, 1, 2).float()).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grad = {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), grads)}
        with torch.no_grad():
            for k, p in self.p.items():
                p.requires_grad_(False)
                mult, decays = group(k)
                d = grad[k] + self.wd * p if decays else grad[k].clone()
                self.buf[k] = d if k not in self.buf else self.momentum * self.buf[k] + d
                p.sub_(self.lr * mult * self.buf[k])
        return loss.detach(), grad


def steps(params: Params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
          stages, lr: float, momentum: float, weight_decay: float,
          conv: Conv = f32_conv) -> Tuple[List[float], Params, Params]:
    """The reference over ``batches`` (one (images, masks) a step): the
    losses, the first step's gradient, and the parameters after the last."""
    trainer = Trainer(params, stages, lr, momentum, weight_decay, conv)
    losses, first = [], None
    for images, masks in batches:
        loss, grad = trainer.step(images, masks)
        losses.append(float(loss))
        first = grad if first is None else first
    return losses, first, trainer.p


@torch.no_grad()
def maps_u8(p: Params, frames: torch.Tensor, stages, conv: Conv = f32_conv,
            batch: int = 4) -> torch.Tensor:
    """(N, H, W) uint8 sigmoid(fused) * 255, rounded, of NHWC frames, in
    batches of ``batch``."""
    out = []
    with exact_f32():
        for i in range(0, frames.shape[0], batch):
            x = frames[i:i + batch].permute(0, 3, 1, 2).float()
            logits = forward(p, x, stages, conv)[:, 0]
            out.append(torch.round(255 * torch.sigmoid(logits)).to(torch.uint8))
    return torch.cat(out)
