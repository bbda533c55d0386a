"""The numbers that decide ``correct``, each against its limit.

Training cells (the reference follows the program's first three steps):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient as the optimizer got it, by the
  worst leaf: |norm(program) - norm(reference)| over the larger of the
  reference leaf's norm and the median leaf's (some gradients are all but
  zero); ``grad_gap_weights`` the same over the weights alone, since a
  bias's gradient, a sum over every pixel, can cancel to a small remainder
  that rounding moves by a large share of itself;
- ``delta_gap``: the parameters' change over the three steps, by the worst
  leaf as above, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf outside the loss's graph moves by
  weight decay and rounding alone).
Serving cells (every real frame's map of every pass, against the
reference's map of its frame, in uint8 codes):
- ``code_gap_max``: the widest gap of a pixel;
- ``code_gap_mean``: the mean absolute gap over all maps;
- ``code_gap_worst_map``: the largest mean absolute gap of one map.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

Norms = Dict[str, float]
MOVES = 1e-3  # a leaf whose reference gradient is under this share of the
              # median leaf's is left out of delta_gap


def norms(tensors: Dict[str, torch.Tensor]) -> Norms:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Norms, ref: Norms, keep: Optional[List[str]] = None
              ) -> Dict[str, float]:
    names = list(ref) if keep is None else keep
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def worst_leaf(prog: Norms, ref: Norms, keep: Optional[List[str]] = None
               ) -> Tuple[float, str]:
    gaps = leaf_gaps(prog, ref, keep)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def moving_leaves(ref_grad: Norms) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= MOVES * med]


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def training_numbers(prog_losses: List[float], ref_losses: List[float],
                     prog_grad: Norms, ref_grad: Norms, prog_delta: Norms,
                     ref_delta: Norms) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of one sequence."""
    weights = [k for k in ref_grad if k.endswith(".weight")]
    return {"loss_gap": (loss_gap(prog_losses, ref_losses), "steps"),
            "grad_gap": worst_leaf(prog_grad, ref_grad),
            "grad_gap_weights": worst_leaf(prog_grad, ref_grad, weights),
            "delta_gap": worst_leaf(prog_delta, ref_delta,
                                    moving_leaves(ref_grad))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[str]]:
    """(all within their limits, the lines 'name value limit')."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = numbers[name]
        fine = value <= limit
        ok &= fine
        lines.append(f"{name} {value!r} limit {limit!r}{'' if fine else ' FAILED'}")
    return ok, lines
