"""Parent-network training on the card.

Counterpart of ``osvos_tpu/train/parent.py``. The reference trains the
parent for 240 epochs over every train-split (frame, mask) pair at batch 1,
with flip and ScaleNRotate host augmentation, gradient accumulation over
``nAveGrad = 10`` samples, and deep supervision annealed to zero:
``loss = (1 - epoch / nEpochs) * sum(side losses) + fuse loss``. Snapshots
every 40 epochs and a val-loss probe every 5.

Each loss is the batch mean of the per-sample class-balanced BCE, so a
batch-n step with ``n_ave_grad=1`` gives the same gradient and momentum
timing as n accumulated batch-1 calls. ``loss_impl='pallas'`` takes the
CB-BCE through the CUDA kernels of ``ops/kernels/cbbce.py`` (B13, B14): one
statistics and one gradient launch per output, five per call.

The host pipeline (augmentation with ``data/transforms.py``, batching)
runs in a background thread feeding a small prefetch queue. The JAX
package's mesh and ``make_sharded`` come with ROADMAP.md A.5.
"""

from __future__ import annotations

import contextlib
import queue
import random
import threading
from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from osvos_torch.configs import DataConfig, ModelConfig, ParentConfig
from osvos_torch.data.davis import iterate_batches
from osvos_torch.data.transforms import (Compose, RandomHorizontalFlip,
                                         Resize, ScaleNRotate, ToArray)
from osvos_torch.models.vgg_osvos import OSVOS
from osvos_torch.ops.loss import (class_balanced_cross_entropy_loss,
                                  class_balanced_cross_entropy_loss_per_sample)
from osvos_torch.train.online import DeviceLike, resolve_device
from osvos_torch.train.optim import MultiSteps, make_osvos_optimizer
from osvos_torch.utils.precision import exact_f32

Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[OSVOS, torch.Tensor, torch.Tensor, float],
                  Tuple[torch.Tensor, torch.Tensor]]
StepFn = Callable[[OSVOS, MultiSteps, torch.Tensor, torch.Tensor, float],
                  Metrics]


def make_parent_train_step(model_config: ModelConfig,
                           cfg: ParentConfig) -> Tuple[LossFn, StepFn]:
    """``(loss_fn, step)``.

    ``loss_fn(model, images, gts, side_weight) -> (total, per_output)``:
    the five train-mode outputs' batch-mean CB-BCE losses (per_output, (5,))
    and ``side_weight * sum(side losses) + fuse loss``; ``side_weight`` is
    the annealed ``1 - epoch / nEpochs``.

    ``step(model, optimizer, images, gts, side_weight) -> {'total',
    'per_output'}``: backpropagates the total of one call and hands its
    gradient to the accumulating optimizer (``train/optim.MultiSteps``).
    """
    impl = cfg.loss_impl
    precise = exact_f32 if model_config.compute_mode == "parity" \
        else contextlib.nullcontext

    def loss_fn(model: OSVOS, images: torch.Tensor, gts: torch.Tensor,
                side_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = model(images, mode="train")
        losses = [class_balanced_cross_entropy_loss_per_sample(
            o, gts, impl=impl).mean() for o in outs]
        total = side_weight * sum(losses[:-1]) + losses[-1]
        return total, torch.stack(losses)

    def step(model: OSVOS, optimizer: MultiSteps, images: torch.Tensor,
             gts: torch.Tensor, side_weight: float) -> Metrics:
        optimizer.zero_grad()
        with precise():
            total, losses = loss_fn(model, images, gts, side_weight)
            total.backward()
        optimizer.step()
        return {"total": total.detach(), "per_output": losses.detach()}

    return loss_fn, step


class ParentTrainer:
    """Owns a private copy of the weights, the accumulating grouped SGD and
    the step; ``device`` defaults to the card."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 model_config: ModelConfig, cfg: ParentConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.model_config = model_config
        self.device = resolve_device(device)
        self.model = OSVOS(model_config)
        self.model.load_state_dict(params)  # copies: the caller's stay
        self.model.to(self.device).train()
        named = list(self.model.named_parameters())
        sgd = make_osvos_optimizer(named, base_lr=cfg.lr,
                                   momentum=cfg.momentum,
                                   weight_decay=cfg.weight_decay)
        self.optimizer = MultiSteps(named, sgd, cfg.n_ave_grad)
        _, self._step = make_parent_train_step(model_config, cfg)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    @property
    def opt_state(self) -> Dict[str, object]:
        return self.optimizer.state_dict()

    def load(self, params: Mapping[str, torch.Tensor],
             opt_state: Mapping[str, object]) -> None:
        """Resume from a snapshot's (or a carried JAX) state."""
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt_state)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def train_step(self, images: np.ndarray, gts: np.ndarray,
                   side_weight: float) -> Metrics:
        """One call: (B, H, W, 3) images and (B, H, W, 1) gts; the
        optimizer steps on every ``n_ave_grad``-th call. The metrics stay
        on the device."""
        return self._step(self.model, self.optimizer, self._tensor(images),
                          self._tensor(gts), side_weight)

    @torch.no_grad()
    def val_loss(self, images: np.ndarray, gts: np.ndarray) -> float:
        """The fused output's CB-BCE summed over pixels and divided by the
        batch size (the JAX package's ``_eval_loss``)."""
        precise = exact_f32 if self.model_config.compute_mode == "parity" \
            else contextlib.nullcontext
        with precise():
            fused = self.model(self._tensor(images), mode="train")[-1]
            return float(class_balanced_cross_entropy_loss(
                fused, self._tensor(gts), size_average=False))


def make_train_pipeline(dataset, data_config: DataConfig, cfg: ParentConfig,
                        input_res: Tuple[int, int] = (480, 854),
                        seed: int = 0, prefetch: int = 4
                        ) -> Tuple[object, Callable[[], Iterator[dict]]]:
    """``(dataset, epoch_batches)``: the dataset with the training
    transforms (flip, ScaleNRotate, Resize to ``input_res``, ToArray) drawn
    from ``random.Random(seed)``, and a factory of one epoch's shuffled
    batches (``np.random.RandomState(seed)``), made by a background thread
    ``prefetch`` batches ahead; an error in that thread is raised in the
    consumer.

    ``dataset`` is indexable, with a ``transform`` attribute, and returns
    ``DAVIS2016``'s samples (``data/davis.DAVIS2016`` or
    ``data/synthetic.SyntheticDAVIS``).
    """
    host_rng = random.Random(seed)
    dataset.transform = Compose([
        RandomHorizontalFlip(data_config.hflip_prob, rng=host_rng),
        ScaleNRotate(data_config.rots, data_config.scales, rng=host_rng),
        Resize(input_res),
        ToArray(),
    ])
    np_rng = np.random.RandomState(seed)

    def epoch_batches() -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()

        def producer():
            try:
                for batch in iterate_batches(dataset, cfg.batch_size,
                                             shuffle=True, rng=np_rng):
                    q.put(batch)
            except Exception as e:  # raised again in the consumer
                q.put(e)
            finally:
                q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    return dataset, epoch_batches
