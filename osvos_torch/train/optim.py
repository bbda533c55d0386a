"""SGD with the reference's per-module parameter groups.

Counterpart of ``osvos_tpu/train/optim.py``. The reference builds
``optim.SGD`` with parameter groups (train_parent.py:~60-90): trunk conv
weights at the base lr with weight decay, all biases at 2x lr without decay,
score_dsn at lr/10 (bias 2*lr/10), fuse at lr/100 (bias 2*lr/100); the
frozen bilinear upsamplers are constants here, not parameters. Per
parameter, ``torch.optim.SGD`` with dampening 0 does what the JAX package's
optimizer does: ``g += wd * p; buf = mu * buf + g; p -= lr * buf``.

Gradient accumulation over ``n_ave_grad`` calls (``optax.MultiSteps`` in
the JAX package) comes in two forms. The online fine-tune sums
``loss / n_ave_grad`` of each microstep into the same ``.grad`` and steps
once. Parent training, whose calls are separate ``train_step``s, wraps the
optimizer in ``MultiSteps``: it keeps MultiSteps' running mean of the
gradients in float32 and steps on it every ``n_ave_grad``-th call.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Tuple

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


class MultiSteps:
    """``optax.MultiSteps(every_k_schedule=k)`` around a torch optimizer.

    ``step()`` runs after each call's ``zero_grad()`` and backward, with
    that call's gradient in ``.grad`` (zero where the loss does not reach).
    It folds the gradient into the float32 running mean ``acc += (g - acc)
    / (mini_step + 1)``; on the k-th call it puts the mean into ``.grad``,
    steps the optimizer, and resets the mean and ``mini_step`` to zero. On
    the other calls the parameters do not move. Returns whether it stepped.
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 optimizer: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.names, self.params = map(list, zip(*named_params))
        self.optimizer = optimizer
        self.every_k = every_k
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p, dtype=torch.float32)
                          for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        for p, acc in zip(self.params, self.acc_grads):
            acc += (p.grad.float() - acc) / (self.mini_step + 1)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        for p, acc in zip(self.params, self.acc_grads):
            p.grad = acc.to(p.dtype, copy=True)  # never an alias of acc
        self.optimizer.step()
        for acc in self.acc_grads:
            acc.zero_()
        self.mini_step = 0
        return True

    def zero_grad(self) -> None:
        """Zero gradients, not None: torch's SGD skips a parameter without
        one, while the JAX package's optimizer still decays it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()

    def state_dict(self) -> Dict[str, Any]:
        """``mini_step``, and the running mean and momentum buffer (zeros
        before the first step) of each parameter by name."""
        momentum = {}
        for name, p in zip(self.names, self.params):
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            momentum[name] = torch.zeros_like(p) if buf is None else buf.clone()
        return {"mini_step": self.mini_step,
                "acc_grads": {n: a.clone() for n, a in zip(self.names,
                                                           self.acc_grads)},
                "momentum": momentum}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        mini_step = int(state["mini_step"])
        if not 0 <= mini_step < self.every_k:
            raise ValueError(f"mini_step {mini_step} outside [0, {self.every_k})")
        for key in ("acc_grads", "momentum"):
            if sorted(state[key]) != sorted(self.names):
                raise ValueError(f"{key} does not name the parameters")
        self.mini_step = mini_step
        for name, p, acc in zip(self.names, self.params, self.acc_grads):
            a, m = state["acc_grads"][name], state["momentum"][name]
            acc.copy_(a)
            self.optimizer.state[p]["momentum_buffer"] = \
                m.to(device=p.device, dtype=p.dtype).clone()
