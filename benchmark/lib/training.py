"""What the fine-tune drivers share: the configuration as the program's
objects, the checked first steps and the comparison after the window.

A training cell's set-up builds one model and optimizer, drives them
through the window's own call (the program's chunk) for the first
``checked_steps`` steps on pool rows that all differ, and keeps of them
what the comparison needs: each step's loss, the first step's gradient as
the optimizer got it (its momentum buffer after one step less the weight
decay, ``buf = g + wd * p0``), and the parameters' change after the last
checked step. After the window the reference follows the same steps from
the same weights and samples.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import compare, osvos

Params = Dict[str, torch.Tensor]


def model_config(cfg: dict, mode: str = None):
    from osvos_torch.configs import ModelConfig

    return ModelConfig(stages=tuple(tuple(s) for s in cfg["stages"]),
                       side_channels=cfg["side_channels"],
                       compute_mode=mode or cfg["compute_mode"])


def online_config(cfg: dict):
    from osvos_torch.configs import OnlineConfig

    o = dict(cfg["online"])
    for key in ("rots", "scales"):
        o[key] = tuple(o[key])
    return OnlineConfig(**o)


def first_gradient(optimizer, names: Dict[int, str], p0: Params,
                   index=None) -> Dict[str, torch.Tensor]:
    """The gradient the optimizer took in its first step, from its state:
    ``buf - wd * p0`` of each leaf (``index`` picks a sequence's slice of
    a stacked leaf). A leaf without a buffer (the optimizer never
    stepped) took none: zeros."""
    out = {}
    for group in optimizer.param_groups:
        wd = group["weight_decay"]
        for p in group["params"]:
            name = names[id(p)]
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is None:
                buf = torch.zeros_like(p) + wd * p.detach()
            if index is not None:
                buf = buf[index]
            out[name] = buf.double() - wd * p0[name].double()
    return out


def delta(model, p0: Params, index=None) -> Dict[str, torch.Tensor]:
    out = {}
    for name, p in model.named_parameters():
        v = p.detach() if index is None else p.detach()[index]
        out[name] = v.double() - p0[name].double()
    return out


def sample_batch(pool_imgs: torch.Tensor, pool_masks: torch.Tensor,
                 index: torch.Tensor, flip: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step's (images, masks) as the traffic defines them: the pool's
    rows ``index``, each flipped left to right where ``flip``."""
    imgs = pool_imgs.index_select(0, index).float()
    masks = pool_masks.index_select(0, index).float()
    f = flip[:, None, None, None]
    return (torch.where(f, imgs.flip(2), imgs),
            torch.where(f, masks.flip(2), masks))


def reference_numbers(p0: Params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                      cfg: dict, prog_losses: List[float], prog_grad: Dict[str, float],
                      prog_delta: Dict[str, float]) -> Dict[str, Tuple[float, str]]:
    """The reference over ``batches`` from ``p0``, compared with the
    program's readings of one sequence."""
    o = cfg["online"]
    losses, grad, p_end = osvos.steps(p0, batches, cfg["stages"], o["lr"],
                                      o["momentum"], o["weight_decay"])
    ref_delta = {k: p_end[k].double() - p0[k].double() for k in p0}
    return compare.training_numbers(prog_losses, losses, prog_grad,
                                    compare.norms(grad), prog_delta,
                                    compare.norms(ref_delta))


def worst(per_sequence: List[Dict[str, Tuple[float, str]]]
          ) -> Dict[str, Tuple[float, str]]:
    out = {}
    for numbers in per_sequence:
        for k, (v, where) in numbers.items():
            if k not in out or v > out[k][0]:
                out[k] = (v, where)
    return out
