"""The packed schedule: one model over the S sequences of a rank.

Counterpart of the JAX package's ``schedule='packed'``
(``osvos_tpu/parallel/batched_online.py``), which ``jax.vmap``s the online
chunk over a device's sequences. Here the sequences are not vmapped:
``PackedOSVOS`` holds the stacked (S, ...) parameters under ``OSVOS``'s
names and folds the sequence axis into the channels of the trunk, so that
each conv of the S sequences is one grouped conv (``groups=S``) of
(N, H, W, S * C) activations, sequence s in the channels [s * C,
(s + 1) * C). That is what vmapping a conv over stacked kernels lowers to
in XLA (a ``feature_group_count=S`` conv). On the card the weight gradient
of each trunk conv is one launch of the sequence-batched kernel, B17's
``wgrad3x3_seq`` or, at the stem, B16's ``stem_wgrad_seq``
(``ops/fastconv.conv3x3_same_seq``); the pools (B7-B10) work channel by
channel and take the S * C channels as they are; the loss's kernels (B13,
B14) take the S * N samples as rows. Every kernel launches once a layer a
step, whatever S is.

``make_packed_chunk_fn`` is ``train/online.make_chunk_fn`` over the S
sequences: each sequence draws from its own ``Draws`` and pool, its loss is
its own (the per-sample CB-BCE of its rows, meaned), and the loss that is
backpropagated is their sum, so each sequence's gradient is its own. One
``torch.optim.SGD`` over the stacked tensors (``make_osvos_optimizer``, the
same groups) is S independent optimizers: SGD with momentum and weight
decay is elementwise.

Only the online chunk's graph is ported (``OSVOS.forward`` with
``mode='infer'``), in the 'parity' and 'fast' modes: the JAX package's
packed schedule downgrades 'flat' to 'fast' (``batched_online.py``), and
inference of the adapted stack goes through ``batched_infer``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.models.vgg_osvos import stage_conv_names
from osvos_torch.ops.crop import center_crop
from osvos_torch.ops.fastconv import conv3x3_same_seq
from osvos_torch.ops.loss import class_balanced_cross_entropy_loss_per_sample
from osvos_torch.ops.pool import max_pool_ceil
from osvos_torch.ops.upsample import bilinear_upsample
from osvos_torch.ops.warp import apply_scale_n_rotate
from osvos_torch.train.online import Draws, _check_modes
from osvos_torch.utils.precision import exact_f32
from osvos_torch.utils.profiling import span


class StackedConv(nn.Module):
    """S convs of one shape: weight (S, out, in, k, k), bias (S, out)."""

    def __init__(self, s: int, in_ch: int, out_ch: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(s, out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(s, out_ch))


def interleave(t: torch.Tensor, s: int) -> torch.Tensor:
    """(S * N, H, W, C) rows, sequence-major, as the (N, H, W, S * C) input
    of the packed trunk: sequence s's sample n in the channels
    [s * C, (s + 1) * C) of batch row n."""
    sn, h, w, c = t.shape
    return t.reshape(s, sn // s, h, w, c).permute(1, 2, 3, 0, 4).reshape(
        sn // s, h, w, s * c)


def sequence_rows(out: torch.Tensor) -> torch.Tensor:
    """(N, H, W, S) packed logits as (S * N, H, W, 1) rows, sequence-major."""
    n, h, w, s = out.shape
    return out.permute(3, 0, 1, 2).reshape(s * n, h, w, 1)


class PackedOSVOS(nn.Module):
    """``OSVOS`` over S sequences with stacked parameters (module docstring).

    ``state_dict()`` is the stacked state of ``parallel/batched_online.py``
    (every ``OSVOS`` name, each tensor with a leading S axis);
    ``from_stacked`` and ``to_stacked`` convert to and from it. ``forward``
    runs ``OSVOS.forward(x, mode='infer')`` of every sequence.
    """

    def __init__(self, config: ModelConfig, s: int):
        super().__init__()
        if config.compute_mode not in ("parity", "fast"):
            raise ValueError(f"PackedOSVOS runs the 'parity' and 'fast' "
                             f"modes, not {config.compute_mode!r}")
        self.config, self.s = config, s
        self._fast_vjp = config.compute_mode == "fast" and config.fast_conv_vjp
        for name, in_ch, out_ch in stage_conv_names(config.stages):
            self.add_module(name, StackedConv(s, in_ch, out_ch, 3))
        sc = config.side_channels
        n_sides = len(config.stages) - 1
        for i in range(1, n_sides + 1):
            self.add_module(f"side_prep{i}",
                            StackedConv(s, config.stages[i][-1], sc, 3))
            self.add_module(f"score_dsn{i}", StackedConv(s, sc, 1, 1))
        self.fuse = StackedConv(s, n_sides * sc, 1, 1)

    @torch.no_grad()
    def from_stacked(self, state: Mapping[str, torch.Tensor]) -> "PackedOSVOS":
        """Load the stacked (S, ...) state; returns self."""
        self.load_state_dict(state)
        return self

    def to_stacked(self) -> Dict[str, torch.Tensor]:
        """The stacked state, a copy on the parameters' device."""
        return {k: v.detach().clone() for k, v in self.state_dict().items()}

    def _conv3x3(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """SAME 3x3 convs of the S sequences of ``x`` in x's dtype, each
        bias added after (``OSVOS._conv3x3``)."""
        conv = getattr(self, name)
        if self._fast_vjp and name.startswith("stage"):
            y = conv3x3_same_seq(x, conv.weight)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype).flatten(0, 1),
                         padding=1, groups=self.s).permute(0, 2, 3, 1)
        return y + conv.bias.flatten().to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, S * 3) float32 frames, sequence s in channels
        [3 s, 3 s + 3). Returns the (N, H, W, S) fused logits, channel s
        sequence s's ``OSVOS.forward(mode='infer')``."""
        cfg, s = self.config, self.s
        parity = cfg.compute_mode == "parity"
        with exact_f32() if parity else contextlib.nullcontext():
            up_method = "conv" if parity else "matmul"
            crop_h, crop_w = x.shape[1], x.shape[2]
            x = x.to(torch.float32 if parity else torch.bfloat16)
            for j in range(len(cfg.stages[0])):
                x = F.relu(self._conv3x3(x, f"stage1_conv{j}"))
            fuse_w = self.fuse.weight[:, 0, :, 0, 0].float()  # (S, sides * sc)
            sc = cfg.side_channels
            contribs = []
            for i, widths in enumerate(cfg.stages[1:], start=1):
                x = max_pool_ceil(x)
                for j in range(len(widths)):
                    x = F.relu(self._conv3x3(x, f"stage{i + 1}_conv{j}"))
                side = self._conv3x3(x, f"side_prep{i}").float()
                n, h, w, _ = side.shape
                # each sequence's side features times its fuse weights
                contrib = torch.einsum("nhwsc,sc->nhws", side.reshape(n, h, w, s, sc),
                                       fuse_w[:, (i - 1) * sc:i * sc])
                contribs.append(center_crop(
                    bilinear_upsample(contrib, 2 ** i, up_method), crop_h, crop_w))
            return sum(contribs) + self.fuse.bias[:, 0]


def stack_draws(draws: Sequence[Draws]) -> Draws:
    """One ``Draws`` a sequence as one whose fields are (S, n_steps,
    n_ave_grad)."""
    return Draws(**{f: None if getattr(draws[0], f) is None
                    else torch.stack([getattr(d, f) for d in draws])
                    for f in ("flip", "index", "angle", "scale")})


def draws_steps(draws: Draws, start: int, stop: int) -> Draws:
    """Steps [start, stop) of stacked draws."""
    return draws._map(lambda t: t[:, start:stop])


def make_packed_chunk_fn(model_config: ModelConfig, cfg: OnlineConfig,
                         aug_mode: str = "pool", step_mode: str = "microbatch"):
    """``chunk(model, optimizer, pool_imgs, pool_masks, draws) -> losses``:
    ``train/online.make_chunk_fn``'s chunk over the S sequences of a
    ``PackedOSVOS``. pool_imgs (S, P, H, W, 3) and pool_masks (S, P, H, W,
    1), in any float dtype (made float32 after the draw), sequence s's pool
    in row s (aug_mode 'per_step': its pair, P = 1); ``draws`` stacked
    (``stack_draws``), row s sequence s's. Returns the (S, len) float32
    losses, each sequence's as ``make_chunk_fn`` gives it.

    Per step, each sequence's ``n_ave_grad`` samples are drawn from its
    pool and laid out in the channels (``interleave``) on the pool's
    device. 'microbatch': one forward of the batch, sequence s's loss the
    mean of its samples' per-sample CB-BCE; 'sequential': ``n_ave_grad``
    batch-1 forwards, sequence s's loss of microstep j the per-sample
    CB-BCE of its row j over ``n_ave_grad``. The sum over the sequences of
    their losses is backpropagated: sequence s's gradient is its own loss's.
    """
    _check_modes(aug_mode, step_mode)
    n = cfg.n_ave_grad
    impl = cfg.loss_impl
    precise = exact_f32 if model_config.compute_mode == "parity" \
        else contextlib.nullcontext

    def draw(pool_imgs, pool_masks, draws: Draws, t: int):
        """The (S * n, H, W, C) images and masks of step t, sequence-major."""
        s = pool_imgs.shape[0]
        if aug_mode == "pool":
            rows = (torch.arange(s, device=pool_imgs.device)[:, None]
                    * pool_imgs.shape[1] + draws.index[:, t]).reshape(-1)
            imgs = pool_imgs.flatten(0, 1).index_select(0, rows).float()
            masks = pool_masks.flatten(0, 1).index_select(0, rows).float()
            flip = draws.flip[:, t].reshape(-1)[:, None, None, None]
            return (torch.where(flip, imgs.flip(2), imgs),
                    torch.where(flip, masks.flip(2), masks))
        pairs = [apply_scale_n_rotate(pool_imgs[i, 0].float(),
                                      pool_masks[i, 0].float(),
                                      draws.flip[i, t, j], draws.angle[i, t, j],
                                      draws.scale[i, t, j])
                 for i in range(s) for j in range(n)]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))

    def step_loss(model, imgs, masks) -> torch.Tensor:
        """Backpropagates one step's losses into ``.grad``; returns the
        (S,) losses."""
        s = model.s
        if step_mode == "microbatch":
            with span("step.forward", device=True):
                out = model(interleave(imgs, s))
                per = class_balanced_cross_entropy_loss_per_sample(
                    sequence_rows(out), masks, impl=impl)
                loss = per.view(s, n).mean(1)
            with span("step.backward", device=True):
                loss.sum().backward()
            return loss.detach()
        imgs = imgs.view(s, n, *imgs.shape[1:])
        masks = masks.view(s, n, *masks.shape[1:])
        total = torch.zeros(s, device=imgs.device)
        for j in range(n):
            with span("step.forward", device=True):
                out = model(interleave(imgs[:, j], s))
                loss = class_balanced_cross_entropy_loss_per_sample(
                    sequence_rows(out), masks[:, j], impl=impl) / n
                total = total + loss.detach()
            with span("step.backward", device=True):
                loss.sum().backward()
        return total

    def chunk(model: PackedOSVOS, optimizer: torch.optim.Optimizer,
              pool_imgs: torch.Tensor, pool_masks: torch.Tensor,
              draws: Draws) -> torch.Tensor:
        steps = draws.flip.shape[1]
        with span("train.chunk"):
            losses = torch.empty((model.s, steps), dtype=torch.float32,
                                 device=pool_imgs.device)
            # zero gradients, not None, for the leaves outside the 'infer'
            # graph (score_dsn), as make_chunk_fn does
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.zero_grad(set_to_none=False)
            for t in range(steps):
                with span("step.draw", device=True):
                    imgs, masks = draw(pool_imgs, pool_masks, draws, t)
                with precise():
                    losses[:, t] = step_loss(model, imgs, masks)
                # the next step's gradients are zeroed here, the last
                # step's are left for the caller to read
                with span("step.optimizer", device=True):
                    optimizer.step()
                    if t + 1 < steps:
                        optimizer.zero_grad(set_to_none=False)
        return losses

    return chunk
