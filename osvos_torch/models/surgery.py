"""Parameter initialization and weight conversion.

Counterpart of ``osvos_tpu/models/surgery.py``. The port's state is the
``state_dict`` of ``models.vgg_osvos.OSVOS``: ``<name>.weight`` (OIHW) and
``<name>.bias`` for every conv, named as the JAX package's parameter tree.

- ``init_osvos_params``: the reference initialisation (trunk lecun-normal,
  side_prep / score_dsn / fuse N(0, 0.001), zero biases), optionally with
  the trunk copied from torchvision VGG-16 ``features`` weights.
- ``load_torch_state_dict``: the reference OSVOS ``state_dict`` names
  (``stages.<s>.<idx>``, ``side_prep.<i>``, ``score_dsn.<i>``, ``fuse``),
  with the frozen bilinear upsamplers checked and dropped.
- ``params_from_jax`` / ``params_to_jax``: the JAX package's nested
  ``{name: {"kernel": HWIO, "bias"}}`` tree of numpy arrays and back;
  ``opt_state_from_jax``: the JAX parent trainer's optimizer state (as
  nested dicts of numpy arrays) as the port's ``train/optim.MultiSteps``
  state.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from osvos_torch.configs import ModelConfig
from osvos_torch.models.vgg_osvos import OSVOS, stage_conv_names
from osvos_torch.ops.upsample import interp_surgery_weights

State = Dict[str, torch.Tensor]
JaxTree = Dict[str, Dict[str, np.ndarray]]

# flax's lecun_normal draws a normal truncated at +-2 std and divides the
# std by the truncated distribution's std so the variance stays 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _head_shapes(config: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """OIHW weight shapes of the layers the reference adds to VGG-16."""
    sc = config.side_channels
    shapes: Dict[str, Tuple[int, ...]] = OrderedDict()
    for i, widths in enumerate(config.stages[1:], start=1):
        shapes[f"side_prep{i}"] = (sc, widths[-1], 3, 3)
        shapes[f"score_dsn{i}"] = (1, sc, 1, 1)
    shapes["fuse"] = (1, (len(config.stages) - 1) * sc, 1, 1)
    return shapes


def init_osvos_params(config: ModelConfig = ModelConfig(),
                      generator: Optional[torch.Generator] = None,
                      device: Union[str, torch.device] = "cpu",
                      trunk_weights: Optional[Mapping[str, Any]] = None
                      ) -> State:
    """A fresh state for ``OSVOS(config)`` with the reference distributions.

    Trunk kernels are lecun-normal (flax's default, truncated at 2 std) with
    zero bias; the new layers get N(0, 0.001) kernels and zero bias, as the
    reference's ``_initialize_weights``. The numbers differ from the JAX
    package's for the same seed: use ``params_from_jax`` to share weights.

    trunk_weights: a torchvision VGG-16 ``features`` state (numpy arrays or
    tensors), keys ``features.<idx>.weight`` / ``.bias`` in OIHW; its convs
    are copied onto the trunk in index order, the reference's walk.
    """
    state: State = OrderedDict()
    for name, in_ch, out_ch in stage_conv_names(config.stages):
        std = math.sqrt(1.0 / (9 * in_ch)) / _TRUNC_STD
        w = torch.empty(out_ch, in_ch, 3, 3)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        state[f"{name}.weight"] = w
        state[f"{name}.bias"] = torch.zeros(out_ch)
    for name, shape in _head_shapes(config).items():
        w = torch.empty(shape)
        nn.init.normal_(w, 0.0, 0.001, generator=generator)
        state[f"{name}.weight"] = w
        state[f"{name}.bias"] = torch.zeros(shape[0])
    if trunk_weights is not None:
        _apply_vgg_features(state, trunk_weights, config)
    return OrderedDict((k, v.to(device)) for k, v in state.items())


def _as_f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, np.float32))


def _apply_vgg_features(state: State, feats: Mapping[str, Any],
                        config: ModelConfig) -> None:
    """Copy the ``features.<idx>`` convs onto the trunk in index order."""
    indices = sorted({int(k.split(".")[1]) for k in feats
                      if k.startswith("features.") and k.endswith(".weight")})
    names = stage_conv_names(config.stages)
    if len(indices) < len(names):
        raise ValueError(f"VGG features has {len(indices)} convs, the trunk "
                         f"needs {len(names)}")
    for (name, in_ch, out_ch), idx in zip(names, indices):
        w = _as_f32(feats[f"features.{idx}.weight"])
        if tuple(w.shape) != (out_ch, in_ch, 3, 3):
            raise ValueError(f"features.{idx}.weight has shape "
                             f"{tuple(w.shape)}, {name} needs "
                             f"{(out_ch, in_ch, 3, 3)}")
        state[f"{name}.weight"] = w
        state[f"{name}.bias"] = _as_f32(feats[f"features.{idx}.bias"])


def load_torch_state_dict(state: Mapping[str, np.ndarray],
                          config: ModelConfig = ModelConfig(),
                          check_upsample: bool = True) -> State:
    """The port's state from a reference OSVOS ``state_dict`` (as numpy or
    tensors). Trunk keys ``stages.<s>.<idx>.weight`` are ordered by their
    integer index (the index skips ReLU and pool slots)."""
    def arr(key: str) -> torch.Tensor:
        v = state[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return torch.tensor(np.asarray(v, np.float32))

    out: State = OrderedDict()
    stage_keys: Dict[int, List[int]] = {}
    for k in state:
        if k.startswith("stages.") and k.endswith(".weight"):
            parts = k.split(".")
            stage_keys.setdefault(int(parts[1]), []).append(int(parts[2]))
    for s, widths in enumerate(config.stages):
        idxs = sorted(stage_keys.get(s, []))
        if len(idxs) != len(widths):
            raise ValueError(f"stage {s}: found {len(idxs)} convs, "
                             f"expected {len(widths)}")
        for j, idx in enumerate(idxs):
            out[f"stage{s + 1}_conv{j}.weight"] = arr(f"stages.{s}.{idx}.weight")
            out[f"stage{s + 1}_conv{j}.bias"] = arr(f"stages.{s}.{idx}.bias")

    for i in range(len(config.stages) - 1):
        for src, dst in ((f"side_prep.{i}", f"side_prep{i + 1}"),
                         (f"score_dsn.{i}", f"score_dsn{i + 1}")):
            out[f"{dst}.weight"] = arr(f"{src}.weight")
            out[f"{dst}.bias"] = arr(f"{src}.bias")
        if check_upsample:
            for src in (f"upscale.{i}.weight", f"upscale_.{i}.weight"):
                if src not in state:
                    continue
                w = arr(src).numpy()
                want = interp_surgery_weights(w.shape[0], w.shape[-1])
                if not np.allclose(w, want, atol=1e-5):
                    raise ValueError(
                        f"{src} deviates from the frozen bilinear kernel; "
                        "this checkpoint trained its upsamplers, which the "
                        "model holds as constants")
    out["fuse.weight"] = arr("fuse.weight")
    out["fuse.bias"] = arr("fuse.bias")
    return out


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]]) -> State:
    """The port's state from the JAX package's parameter tree: HWIO kernels
    become OIHW weights; values are copied, never shared."""
    state: State = OrderedDict()
    for name, leaf in tree.items():
        kernel = np.asarray(leaf["kernel"], np.float32)
        state[f"{name}.weight"] = torch.tensor(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
    return state


def opt_state_from_jax(opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The state of ``train/optim.MultiSteps`` from the JAX package's
    parent optimizer state, as nested dicts of numpy arrays (what
    ``flax.serialization.to_state_dict`` makes of it, and what its
    checkpoints hold): MultiSteps' ``mini_step``, ``acc_grads`` and the
    grouped SGD's ``TraceState`` trace (``inner_opt_state``), or a bare
    ``{'trace': tree}`` when ``n_ave_grad`` is 1. Kernels become OIHW."""
    if "acc_grads" in opt_state:
        return {"mini_step": int(np.asarray(opt_state["mini_step"])),
                "acc_grads": params_from_jax(opt_state["acc_grads"]),
                "momentum": params_from_jax(
                    opt_state["inner_opt_state"]["trace"])}
    momentum = params_from_jax(opt_state["trace"])
    return {"mini_step": 0, "momentum": momentum,
            "acc_grads": {k: torch.zeros_like(v) for k, v in momentum.items()}}


def params_to_jax(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> JaxTree:
    """The JAX package's parameter tree (numpy, HWIO) from a model or its
    state."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    tree: JaxTree = {}
    for key, value in state.items():
        name, kind = key.rsplit(".", 1)
        v = value.detach().to("cpu", torch.float32).numpy()
        if kind == "weight":
            tree.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                v.transpose(2, 3, 1, 0))
        else:
            tree.setdefault(name, {})["bias"] = v.copy()
    return tree


# spread_head's targets: logits over about +-8 around a small offset.
_SPREAD_STD = 4.0
_SPREAD_BIAS = 0.5


@torch.no_grad()
def spread_head(model: OSVOS, images: torch.Tensor) -> float:
    """Rescale the fuse weights so that the fused logits on ``images`` have
    standard deviation 4, and set the fuse bias to 0.5; returns the scale.

    With the reference init every u8 output is 127 or 128, so a comparison
    of two inference paths at that init shows almost nothing. Checks and
    benchmarks with random weights call this first, so the logits spread
    over about +-8 and the outputs cover most u8 codes. The contributions
    are linear in the fuse weights, so one forward suffices.
    """
    logits = model(images, mode="infer")[0] - model.fuse.bias
    std = float(logits.float().std())
    if not std > 0:
        raise ValueError("the fused logits do not vary; cannot spread them")
    scale = _SPREAD_STD / std
    model.fuse.weight.mul_(scale)
    model.fuse.bias.fill_(_SPREAD_BIAS)
    return scale
