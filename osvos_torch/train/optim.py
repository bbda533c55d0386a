"""SGD with the reference's per-module parameter groups.

Counterpart of ``osvos_tpu/train/optim.py``. The reference builds
``optim.SGD`` with parameter groups (train_parent.py:~60-90): trunk conv
weights at the base lr with weight decay, all biases at 2x lr without decay,
score_dsn at lr/10 (bias 2*lr/10), fuse at lr/100 (bias 2*lr/100); the
frozen bilinear upsamplers are constants here, not parameters. Per
parameter, ``torch.optim.SGD`` with dampening 0 does what the JAX package's
optimizer does: ``g += wd * p; buf = mu * buf + g; p -= lr * buf``.

Gradient accumulation over ``n_ave_grad`` microsteps (``optax.MultiSteps``
in the JAX package) is the caller's: backpropagate ``loss / n_ave_grad`` of
each microstep into the same ``.grad``, step once, then zero the gradients.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple

import torch


class GroupSpec(NamedTuple):
    lr_mult: float
    weight_decay: float


# Reference group table (train_parent.py:~60-90), the JAX package's
# REFERENCE_GROUPS.
REFERENCE_GROUPS: Mapping[str, GroupSpec] = {
    "stage_w": GroupSpec(1.0, 1.0),   # weight_decay multiplier 1 -> wd
    "stage_b": GroupSpec(2.0, 0.0),
    "side_w": GroupSpec(1.0, 1.0),
    "side_b": GroupSpec(2.0, 0.0),
    "dsn_w": GroupSpec(0.1, 1.0),
    "dsn_b": GroupSpec(0.2, 0.0),
    "fuse_w": GroupSpec(0.01, 1.0),
    "fuse_b": GroupSpec(0.02, 0.0),
}


def param_group_label(name: str) -> str:
    """The group of a parameter named as in ``OSVOS.named_parameters()``
    (``<module>.weight`` or ``<module>.bias``)."""
    module, _, leaf = name.rpartition(".")
    is_bias = leaf == "bias"
    if module.startswith("stage"):
        return "stage_b" if is_bias else "stage_w"
    if module.startswith("side_prep"):
        return "side_b" if is_bias else "side_w"
    if module.startswith("score_dsn"):
        return "dsn_b" if is_bias else "dsn_w"
    if module == "fuse":
        return "fuse_b" if is_bias else "fuse_w"
    raise ValueError(f"unlabelled parameter {name}")


def make_osvos_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    base_lr: float,
    momentum: float = 0.9,
    weight_decay: float = 0.0002,
) -> torch.optim.SGD:
    """Grouped SGD over ``model.named_parameters()``: one parameter group
    per label of ``REFERENCE_GROUPS``, lr ``base_lr * lr_mult`` and weight
    decay ``weight_decay * weight_decay multiplier``, momentum
    ``momentum``, dampening 0."""
    members: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in named_params:
        members.setdefault(param_group_label(name), []).append(p)
    param_groups = [
        {"params": ps, "lr": base_lr * REFERENCE_GROUPS[label].lr_mult,
         "weight_decay": weight_decay * REFERENCE_GROUPS[label].weight_decay,
         "label": label}
        for label, ps in members.items()]
    return torch.optim.SGD(param_groups, lr=base_lr, momentum=momentum,
                           dampening=0.0, weight_decay=0.0)
