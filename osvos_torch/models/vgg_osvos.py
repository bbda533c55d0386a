"""The OSVOS network in PyTorch.

Counterpart of ``osvos_tpu/models/vgg_osvos.py`` in its 'parity', 'fast'
and 'flat' compute modes: a VGG-16 trunk in five stages with ceil-mode 2x2 pooling
between them; for each of stages 2-5 a 3x3 side_prep conv to 16 channels, a
1x1 score_dsn conv to one logit, fixed bilinear upsampling back to the input
size and a center crop; and a 1x1 fuse conv over the concatenated side
features. ``forward`` returns ``[side1..side4, fuse]`` like the reference.

Tensors at the interface are NHWC, as in the JAX package. The convolutions
see the NCHW view of an NHWC tensor, which is channels_last in memory, so the
trunk runs channels_last on the card without a copy.

Modes:
- 'parity': float32 with TF32 off for cuDNN and matmul (``exact_f32``).
- 'fast': bf16 weights and activations in the trunk and side_prep convs
  (f32 parameters, cast per call), the bias added in bf16 after the conv as
  ``osvos_tpu/ops/fastconv.py`` does; the head collapse, score_dsn and the
  upsampling run in f32. With ``fast_conv_vjp`` (the default) the trunk
  convs go through ``ops/fastconv.conv3x3_same``, whose weight gradient is
  float32 as the JAX package's ``_FastConv``; the side_prep convs stay plain
  bf16 convs under autograd, as the JAX package's ``nn.Conv``.
- 'flat' (``flat_side='stacked'``), the online fine-tune's default trunk:
  every conv is a hand-written kernel of ``ops/flatconv.py`` on NHWC bf16
  post-ReLU activations (bias and ReLU in the conv's epilogue, one bf16
  rounding); stage 1's last conv carries the stage-boundary pool, and each
  side_prep conv of stages 2-4 the next stage's pool. The head is hoisted
  as the JAX package's: ``both = side @ [w_fuse_i | w_score_i] + b2`` in
  float32, b2 holding the side_prep bias, so its gradient stays float32.
  The TPU layouts behind ``flat_side`` 'pallas' and 'xla' are not ported.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from osvos_torch.configs import ModelConfig
from osvos_torch.ops.crop import center_crop
from osvos_torch.ops.fastconv import conv3x3_same
from osvos_torch.ops.flatconv import (conv_pool, flat_conv3x3,
                                      flat_conv3x3_input, flat_side_conv3x3_fl,
                                      side_and_pool_fl)
from osvos_torch.ops.pool import max_pool_ceil
from osvos_torch.ops.upsample import bilinear_upsample
from osvos_torch.utils.precision import exact_f32

_NOT_PORTED = {
    "int8": "ROADMAP.md A.6 (int8 inference)",
}
MODES = ("train", "infer", "infer_parts")


def stage_conv_names(stages: Sequence[Sequence[int]] = ModelConfig().stages
                     ) -> List[Tuple[str, int, int]]:
    """(param_name, in_ch, out_ch) for the trunk convs in forward order."""
    names = []
    in_ch = 3
    for i, widths in enumerate(stages):
        for j, width in enumerate(widths):
            names.append((f"stage{i + 1}_conv{j}", in_ch, width))
            in_ch = width
    return names


class OSVOS(nn.Module):
    """VGG-16 FCN with deeply supervised side outputs and a fusion head.

    Parameters are named as the JAX package's tree (``stage1_conv0``,
    ``side_prep1``, ``score_dsn1``, ``fuse``), each an ``nn.Conv2d`` with an
    OIHW weight; ``models.surgery`` converts between the two.
    """

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        mode = config.compute_mode
        if mode in _NOT_PORTED:
            raise NotImplementedError(
                f"compute_mode={mode!r} is not ported yet; it comes with "
                f"{_NOT_PORTED[mode]}")
        if mode not in ("parity", "fast", "flat"):
            raise ValueError(f"unknown compute_mode {mode!r}")
        if mode == "flat" and config.flat_side != "stacked":
            raise NotImplementedError(
                f"flat_side={config.flat_side!r} is a TPU layout that is not "
                "ported (ROADMAP.md \"Not to port as TPU layouts\"); the "
                "port runs flat_side='stacked'")
        if mode == "flat" and len(config.stages[0]) < 2:
            raise ValueError("compute_mode='flat' pools in stage 1's last "
                             "conv, after the stem: stage 1 needs two convs")
        self.config = config
        self._fast_vjp = mode == "fast" and config.fast_conv_vjp
        for name, in_ch, out_ch in stage_conv_names(config.stages):
            self.add_module(name, nn.Conv2d(in_ch, out_ch, 3, padding=1))
        sc = config.side_channels
        n_sides = len(config.stages) - 1
        for i in range(1, n_sides + 1):
            self.add_module(f"side_prep{i}",
                            nn.Conv2d(config.stages[i][-1], sc, 3, padding=1))
            self.add_module(f"score_dsn{i}", nn.Conv2d(sc, 1, 1))
        self.fuse = nn.Conv2d(n_sides * sc, 1, 1)

    def _conv3x3(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """SAME 3x3 conv of NHWC ``x`` in x's dtype, bias added after."""
        conv = getattr(self, name)
        if self._fast_vjp and name.startswith("stage"):
            y = conv3x3_same(x, conv.weight)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                         padding=1).permute(0, 2, 3, 1)
        return y + conv.bias.to(x.dtype)

    def forward(self, x: torch.Tensor, mode: str = "train") -> List[torch.Tensor]:
        """x: (N, H, W, 3) float32 frames (BGR minus the caffe mean).

        mode='train': five (N, H, W, 1) float32 logit maps, four side outputs
        and the fused output.
        mode='infer': ``[fused]`` through the collapsed head: the bilinear
        upsample is channel-diagonal and fuse is 1x1, so each side branch is
        reduced to one channel before it is upsampled.
        mode='infer_parts': ``[c_1..c_4, bias]``, the (N, h_i, w_i, 1)
        low-resolution contributions and the (1,) fuse bias that the fused
        tail (``ops/kernels/fused_head.py``) consumes.
        """
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if self.config.compute_mode == "flat":
            return self._forward_flat(x, mode)
        parity = self.config.compute_mode == "parity"
        with exact_f32() if parity else contextlib.nullcontext():
            return self._forward(x, mode, parity)

    def _forward(self, x: torch.Tensor, mode: str,
                 parity: bool) -> List[torch.Tensor]:
        cfg = self.config
        up_method = "conv" if parity else "matmul"
        crop_h, crop_w = x.shape[1], x.shape[2]
        x = x.to(torch.float32 if parity else torch.bfloat16)

        for j in range(len(cfg.stages[0])):
            x = F.relu(self._conv3x3(x, f"stage1_conv{j}"))

        fuse_w = self.fuse.weight[0, :, 0, 0].float()  # (n_sides * sc,)
        sc = cfg.side_channels
        # parity 'train' keeps the reference-shaped concat graph; every other
        # mode collapses each branch to one channel before upsampling
        collapse = mode != "train" or not parity
        side_feats: List[torch.Tensor] = []
        side_logits: List[torch.Tensor] = []
        contribs: List[torch.Tensor] = []
        for i, widths in enumerate(cfg.stages[1:], start=1):
            x = max_pool_ceil(x)
            for j in range(len(widths)):
                x = F.relu(self._conv3x3(x, f"stage{i + 1}_conv{j}"))
            side_temp = self._conv3x3(x, f"side_prep{i}").float()
            factor = 2 ** i
            if collapse:
                w_i = fuse_w[(i - 1) * sc:i * sc, None]  # (sc, 1)
                contrib = side_temp @ w_i
                if mode == "infer_parts":
                    contribs.append(contrib)
                else:
                    contribs.append(center_crop(
                        bilinear_upsample(contrib, factor, up_method),
                        crop_h, crop_w))
                if mode != "train":
                    continue
            else:
                side_feats.append(center_crop(
                    bilinear_upsample(side_temp, factor, up_method),
                    crop_h, crop_w))
            score_dsn = getattr(self, f"score_dsn{i}")
            score = side_temp @ score_dsn.weight[0, :, 0, 0, None] \
                + score_dsn.bias
            side_logits.append(center_crop(
                bilinear_upsample(score, factor, up_method), crop_h, crop_w))

        if mode == "infer_parts":
            return contribs + [self.fuse.bias]
        if side_feats:
            out = torch.cat(side_feats, dim=-1) @ fuse_w[:, None] + self.fuse.bias
        else:
            out = sum(contribs) + self.fuse.bias
        if mode == "infer":
            return [out]
        return side_logits + [out]

    def _forward_flat(self, x: torch.Tensor, mode: str) -> List[torch.Tensor]:
        """The flat trunk (``osvos_tpu/models/vgg_osvos.py`` with
        ``compute_mode='flat'``, ``flat_side='stacked'``)."""
        cfg = self.config
        crop_h, crop_w = x.shape[1], x.shape[2]
        conv = self.stage1_conv0
        z = flat_conv3x3_input(x.to(torch.bfloat16).contiguous(), conv.weight,
                               conv.bias)
        last = len(cfg.stages[0]) - 1
        for j in range(1, last + 1):
            conv = getattr(self, f"stage1_conv{j}")
            z = (conv_pool if j == last else flat_conv3x3)(z, conv.weight,
                                                           conv.bias)

        fuse_w = self.fuse.weight[0, :, 0, 0]
        sc = cfg.side_channels
        n_sides = len(cfg.stages) - 1
        side_logits: List[torch.Tensor] = []
        contribs: List[torch.Tensor] = []
        for i, widths in enumerate(cfg.stages[1:], start=1):
            for j in range(len(widths)):
                conv = getattr(self, f"stage{i + 1}_conv{j}")
                z = flat_conv3x3(z, conv.weight, conv.bias)
            side_prep = getattr(self, f"side_prep{i}")
            if i < n_sides:  # the next stage's pool rides the side conv
                side, z = side_and_pool_fl(z, side_prep.weight)
            else:
                side = flat_side_conv3x3_fl(z, side_prep.weight)
            # the head, hoisted: both = [fuse contribution | score] of the
            # side features, the side_prep bias folded into b2
            score_dsn = getattr(self, f"score_dsn{i}")
            w_f = fuse_w[(i - 1) * sc:i * sc]
            w_s = score_dsn.weight[0, :, 0, 0]
            wcat = torch.stack([w_f, w_s], dim=1)  # (sc, 2)
            b_s = side_prep.bias
            b2 = torch.stack([b_s @ w_f, b_s @ w_s + score_dsn.bias[0]])
            both = side.float() @ wcat + b2
            factor = 2 ** i
            contrib = both[..., :1]
            if mode == "infer_parts":
                contribs.append(contrib)
                continue
            contribs.append(center_crop(
                bilinear_upsample(contrib, factor, "matmul"), crop_h, crop_w))
            if mode == "train":
                side_logits.append(center_crop(
                    bilinear_upsample(both[..., 1:], factor, "matmul"),
                    crop_h, crop_w))

        if mode == "infer_parts":
            return contribs + [self.fuse.bias]
        out = sum(contribs) + self.fuse.bias
        if mode == "infer":
            return [out]
        return side_logits + [out]
