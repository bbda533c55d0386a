"""One-shot online fine-tuning on the card.

Counterpart of ``osvos_tpu/train/online.py``. The reference loads parent
weights, then runs ``2000 * nAveGrad`` single-sample passes over the first
(frame, mask) pair of a sequence with flip and ScaleNRotate augmentation,
stepping SGD every ``nAveGrad`` passes on the class-balanced BCE of the
fused output only; then it infers every frame.

The objective uses the model's ``mode='infer'`` graph: the loss reads only
the fused output, which the collapsed head computes without the score_dsn
branches.

Augmentation modes:
- ``pool`` (default): ``pool_size`` warped variants of the training pair,
  entry 0 the pair itself; each sample of a step takes a pool entry and a
  horizontal flip. ``run_online`` builds the pool on the host
  (``build_host_pool``: the reference's ScaleNRotate, bicubic image and
  nearest mask, drawn from ``random.Random(seed)`` in the JAX package's
  order, warped one after another); ``make_fine_tune_fn`` builds it on
  the device (``_augment_pool``).
- ``per_step``: a fresh ScaleNRotate warp (with flip) for every sample.

Step modes:
- ``microbatch`` (default): each optimizer step runs its ``n_ave_grad``
  samples as one batch with loss ``mean_i(loss_i)``, the same gradient and
  update timing as the reference's accumulate-then-step.
- ``sequential``: the reference's literal regime, ``n_ave_grad`` batch-1
  microsteps whose ``loss / n_ave_grad`` gradients add up in ``.grad``
  before one step (``optax.MultiSteps`` in the JAX package).

The augmentation stream is an argument (``Draws``), made by ``make_draws``
from a ``torch.Generator``; JAX's PRNG cannot be reproduced in torch, so the
tests replay the JAX package's draws through the same argument. Losses stay
on the device: a chunk of steps makes no host round trip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.data.transforms import ScaleNRotate, scale_n_rotate
from osvos_torch.models.vgg_osvos import OSVOS
from osvos_torch.ops.loss import (class_balanced_cross_entropy_loss,
                                  class_balanced_cross_entropy_loss_per_sample)
from osvos_torch.ops.warp import apply_scale_n_rotate, draw_scale_n_rotate
from osvos_torch.train.optim import make_osvos_optimizer
from osvos_torch.utils.precision import exact_f32

AUG_MODES = ("pool", "per_step")
STEP_MODES = ("microbatch", "sequential")
DeviceLike = Union[str, torch.device, None]
ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class Draws:
    """The augmentation stream of a run of optimizer steps: (n_steps,
    n_ave_grad) tensors, one entry per sample. ``index`` (int64, pool entry)
    is set for aug_mode='pool', ``angle`` (degrees) and ``scale`` for
    aug_mode='per_step'."""

    flip: torch.Tensor
    index: Optional[torch.Tensor] = None
    angle: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.flip.shape[0]

    def _map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Draws":
        return Draws(**{f.name: None if getattr(self, f.name) is None
                        else fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})

    def steps(self, start: int, stop: int) -> "Draws":
        return self._map(lambda t: t[start:stop])

    def to(self, device: torch.device) -> "Draws":
        return self._map(lambda t: t.to(device))


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device``, by default the card; raises if that is CUDA and CUDA is
    not available (pass ``device='cpu'`` to run on the CPU)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the fine-tune runs on the "
                           "card unless device='cpu' is passed")
    return device


def _check_modes(aug_mode: str, step_mode: str) -> None:
    if aug_mode not in AUG_MODES:
        raise ValueError(f"aug_mode must be one of {AUG_MODES}, got {aug_mode!r}")
    if step_mode not in STEP_MODES:
        raise ValueError(f"step_mode must be one of {STEP_MODES}, got "
                         f"{step_mode!r}")


def make_draws(cfg: OnlineConfig, aug_mode: str, n_steps: int, pool_size: int,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Draws:
    """``n_steps`` optimizer steps' worth of draws from ``generator``, made
    on the generator's device and moved to ``device``: per sample a pool
    index ~ U{0..pool_size-1} and a flip with probability ``hflip_prob``
    (pool), or a flip, an angle ~ U(rots) and a scale ~ U(scales)
    (per_step)."""
    shape = (n_steps, cfg.n_ave_grad)
    gen_device = generator.device if generator is not None else torch.device("cpu")
    target = gen_device if device is None else torch.device(device)
    if aug_mode == "per_step":
        flip, angle, scale = draw_scale_n_rotate(
            n_steps * cfg.n_ave_grad, cfg.rots, cfg.scales, cfg.hflip_prob,
            generator)
        draws = Draws(flip=flip.reshape(shape), angle=angle.reshape(shape),
                      scale=scale.reshape(shape))
    else:
        index = torch.randint(0, pool_size, shape, generator=generator,
                              device=gen_device)
        flip = torch.rand(shape, generator=generator,
                          device=gen_device) < cfg.hflip_prob
        draws = Draws(flip=flip, index=index)
    return draws.to(target)


def build_host_pool(image: np.ndarray, mask: np.ndarray, cfg: OnlineConfig,
                    pool_size: int, seed: int = 0, dtype=np.float32
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The host-warped augmentation pool: (P, H, W, 3), (P, H, W, 1).

    Entry 0 is the pair itself; entries 1..P-1 are ScaleNRotate draws of
    ``random.Random(seed)``, taken here in the JAX package's order (rot,
    then scale, per entry). Flips are not baked in: each step flips
    afresh.
    """
    warp = ScaleNRotate(cfg.rots, cfg.scales, rng=random.Random(seed))
    draws = [warp.draw() for _ in range(pool_size - 1)]
    image = np.asarray(image, np.float32)
    mask = np.asarray(mask, np.float32)
    if mask.ndim == 2:
        mask = mask[..., None]
    imgs = [image] + [scale_n_rotate(image, *d) for d in draws]
    masks = [mask] + [scale_n_rotate(mask, *d) for d in draws]
    return np.stack(imgs).astype(dtype), np.stack(masks).astype(dtype)


def _augment_pool(image: torch.Tensor, mask: torch.Tensor, cfg: OnlineConfig,
                  pool_size: int, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side pool: (pool_size, H, W, 3) images and (pool_size, H, W, 1)
    masks, entry 0 the pair itself and the others ScaleNRotate draws
    without flips (each step flips afresh)."""
    _, angle, scale = draw_scale_n_rotate(pool_size - 1, cfg.rots, cfg.scales,
                                          0.0, generator, image.device)
    no_flip = torch.zeros((), dtype=torch.bool, device=image.device)
    imgs, masks = [image], [mask]
    for a, s in zip(angle, scale):
        img_w, mask_w = apply_scale_n_rotate(image, mask, no_flip, a, s)
        imgs.append(img_w)
        masks.append(mask_w)
    return torch.stack(imgs), torch.stack(masks)


def make_online_optimizer(model: OSVOS, cfg: OnlineConfig) -> torch.optim.SGD:
    return make_osvos_optimizer(model.named_parameters(), base_lr=cfg.lr,
                                momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay)


ChunkFn = Callable[[OSVOS, torch.optim.Optimizer, torch.Tensor, torch.Tensor,
                    Draws], torch.Tensor]


def make_chunk_fn(model_config: ModelConfig, cfg: OnlineConfig,
                  aug_mode: str = "pool",
                  step_mode: str = "microbatch") -> ChunkFn:
    """``chunk(model, optimizer, pool_imgs, pool_masks, draws) -> losses``:
    one optimizer step per row of ``draws``, updating ``model`` and the
    optimizer in place; ``losses`` is the (len(draws),) float32 loss of
    each step on the pool's device (the sum of ``loss / n_ave_grad`` over
    its samples). For aug_mode='per_step' the pool is the (1, H, W, C) pair.
    """
    _check_modes(aug_mode, step_mode)
    n = cfg.n_ave_grad
    impl = cfg.loss_impl
    precise = exact_f32 if model_config.compute_mode == "parity" \
        else contextlib.nullcontext

    def draw(pool_imgs, pool_masks, draws: Draws, s: int):
        if aug_mode == "pool":
            imgs = pool_imgs.index_select(0, draws.index[s])
            masks = pool_masks.index_select(0, draws.index[s])
            flip = draws.flip[s][:, None, None, None]
            return (torch.where(flip, imgs.flip(2), imgs),
                    torch.where(flip, masks.flip(2), masks))
        pairs = [apply_scale_n_rotate(pool_imgs[0], pool_masks[0],
                                      draws.flip[s, j], draws.angle[s, j],
                                      draws.scale[s, j]) for j in range(n)]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))

    def step_loss(model: OSVOS, imgs, masks) -> torch.Tensor:
        """Backpropagates one step's loss into ``.grad``; returns it."""
        if step_mode == "microbatch":
            out = model(imgs, mode="infer")[-1]
            loss = class_balanced_cross_entropy_loss_per_sample(
                out, masks, impl=impl).mean()
            loss.backward()
            return loss.detach()
        total = torch.zeros((), device=imgs.device)
        for j in range(n):
            out = model(imgs[j:j + 1], mode="infer")[-1]
            loss = class_balanced_cross_entropy_loss(
                out, masks[j:j + 1], size_average=False, impl=impl) / n
            loss.backward()
            total = total + loss.detach()
        return total

    def chunk(model: OSVOS, optimizer: torch.optim.Optimizer,
              pool_imgs: torch.Tensor, pool_masks: torch.Tensor,
              draws: Draws) -> torch.Tensor:
        losses = torch.empty(len(draws), dtype=torch.float32,
                             device=pool_imgs.device)
        # Zero gradients, not None, for the leaves outside the 'infer' graph
        # (score_dsn): torch's SGD skips a parameter without a gradient,
        # while the JAX package's optimizer still applies weight decay and
        # momentum to it.
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for s in range(len(draws)):
            imgs, masks = draw(pool_imgs, pool_masks, draws, s)
            optimizer.zero_grad(set_to_none=False)
            with precise():
                losses[s] = step_loss(model, imgs, masks)
            optimizer.step()
        return losses

    return chunk


def _as_pair(image: ArrayLike, mask: ArrayLike,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    image = torch.as_tensor(image, dtype=torch.float32).to(device)
    mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
    return image, (mask if mask.dim() == 3 else mask[..., None])


def make_fine_tune_fn(model_config: ModelConfig, cfg: OnlineConfig,
                      aug_mode: str = "pool", pool_size: int = 100,
                      step_mode: str = "microbatch",
                      device: DeviceLike = None):
    """``fine_tune(model, image, mask, generator=None) -> losses``: build the
    augmentation pool on the device, then run ``cfg.n_steps`` optimizer
    steps on ``model`` (moved to ``device``, updated in place) in one chunk.

    image: (H, W, 3) preprocessed frame; mask: (H, W) or (H, W, 1) in
    {0, 1}; generator: the source of the pool's and the steps' draws
    (default: a CPU generator seeded with ``cfg.seed``). losses: the
    (n_steps,) per-step loss on ``device``. The slice's entry point.
    """
    _check_modes(aug_mode, step_mode)
    device = resolve_device(device)
    chunk = make_chunk_fn(model_config, cfg, aug_mode, step_mode)

    def fine_tune(model: OSVOS, image: ArrayLike, mask: ArrayLike,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        model.to(device)
        image, mask = _as_pair(image, mask, device)
        if aug_mode == "pool":
            pool_imgs, pool_masks = _augment_pool(image, mask, cfg, pool_size,
                                                  generator)
        else:
            pool_imgs, pool_masks = image[None], mask[None]
        draws = make_draws(cfg, aug_mode, cfg.n_steps, pool_size, generator,
                           device)
        return chunk(model, make_online_optimizer(model, cfg), pool_imgs,
                     pool_masks, draws)

    return fine_tune


@dataclasses.dataclass
class OnlineResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor  # (n_steps,) float32


def run_online(params: Dict[str, torch.Tensor], image: ArrayLike,
               mask: ArrayLike, model_config: ModelConfig, cfg: OnlineConfig,
               aug_mode: str = "pool", pool_size: int = 100,
               step_mode: str = "microbatch", pool_seed: Optional[int] = None,
               device: DeviceLike = None, draws: Optional[Draws] = None,
               pool: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> OnlineResult:
    """Single-sequence fine-tune from a parent ``state_dict`` in chunks of
    ``cfg.scan_chunk`` steps; the parent state is not modified.

    aug_mode='pool' takes ``pool`` (the output of ``build_host_pool``) or
    builds it, ``pool_size`` entries from ``pool_seed`` (default
    ``cfg.seed``). ``draws`` (default:
    ``make_draws`` from a generator seeded with ``cfg.seed``) is the
    augmentation stream of the ``cfg.n_steps`` steps.
    """
    _check_modes(aug_mode, step_mode)
    device = resolve_device(device)
    model = OSVOS(model_config)
    model.load_state_dict(params)
    model.to(device)
    if aug_mode == "pool":
        if pool is None:
            pool = build_host_pool(
                np.asarray(image), np.asarray(mask), cfg, pool_size,
                seed=cfg.seed if pool_seed is None else pool_seed)
        pool_imgs, pool_masks = pool
        pool_size = pool_imgs.shape[0]
        pool_imgs = torch.from_numpy(pool_imgs).to(device)
        pool_masks = torch.from_numpy(pool_masks).to(device)
    else:
        pool_size = 1
        pool_imgs, pool_masks = (t[None] for t in _as_pair(image, mask, device))
    if draws is None:
        draws = make_draws(cfg, aug_mode, cfg.n_steps, pool_size,
                           torch.Generator().manual_seed(cfg.seed), device)
    draws = draws.to(device)
    chunk = make_chunk_fn(model_config, cfg, aug_mode, step_mode)
    optimizer = make_online_optimizer(model, cfg)
    chunk_len = max(1, cfg.scan_chunk)
    losses = [chunk(model, optimizer, pool_imgs, pool_masks,
                    draws.steps(start, start + chunk_len))
              for start in range(0, cfg.n_steps, chunk_len)]
    return OnlineResult(params=model.state_dict(), losses=torch.cat(losses))
