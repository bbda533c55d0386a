"""Post-training int8 calibration of the OSVOS trunk.

Counterpart of ``osvos_tpu/models/quantize.py``. The bf16 trunk runs over
calibration frames (each conv's bias added in bf16 after it, then the ReLU;
the ceil-mode pool before stages 2-5), and the max |input| of every trunk
conv, the stem's included, is recorded in ``stage_conv_names`` order. Times a
``margin`` > 1, which leaves headroom for frames hotter than the calibration
set (int8 clips beyond the scale), the result is
``ModelConfig(compute_mode='int8', int8_scales=...)``: static scales spare
each int8 conv the max reduction over its input. Each calibration is the
span ``int8.calibrate`` (on the device's clock) while a profiler runs.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from osvos_torch.configs import ModelConfig
from osvos_torch.ops.pool import max_pool_ceil
from osvos_torch.utils.profiling import span

Images = Union[torch.Tensor, np.ndarray]


def _calibration_maxes(state: Mapping[str, torch.Tensor], images: torch.Tensor,
                       config: ModelConfig) -> torch.Tensor:
    """(n_trunk_convs,) float32 max |input| of each trunk conv."""
    maxes = []
    v = images.to(torch.bfloat16)
    for i, widths in enumerate(config.stages):
        if i > 0:
            v = max_pool_ceil(v)
        for j in range(len(widths)):
            name = f"stage{i + 1}_conv{j}"
            maxes.append(v.abs().amax().float())
            w = state[f"{name}.weight"].to(torch.bfloat16)
            b = state[f"{name}.bias"].to(torch.bfloat16)
            out = F.conv2d(v.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
            v = torch.clamp_min(out + b, 0)
    return torch.stack(maxes)


def _state(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]):
    if isinstance(model_or_state, nn.Module):
        return model_or_state.state_dict()
    return model_or_state


def _on(images: Images, like: torch.Tensor) -> torch.Tensor:
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    return images.to(like.device)


@torch.no_grad()
def calibrate_int8_scales(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]],
                          images: Images, config: ModelConfig = ModelConfig(),
                          margin: float = 1.05) -> Tuple[float, ...]:
    """Per trunk conv max|input| * margin, in ``stage_conv_names`` order,
    from an OSVOS model or its state on its device and (N, H, W, 3)
    preprocessed frames; the product is taken in Python floats, as the JAX
    function does."""
    with span("int8.calibrate", device=True):
        state = _state(model_or_state)
        x = _on(images, next(iter(state.values())))
        maxes = _calibration_maxes(state, x, config)
        return tuple(float(m) * margin for m in maxes.cpu().tolist())


@torch.no_grad()
def calibrate_int8_scales_batched(stacked_states: Mapping[str, torch.Tensor],
                                  images: Images,
                                  config: ModelConfig = ModelConfig(),
                                  margin: float = 1.05) -> torch.Tensor:
    """(S, n_trunk_convs) float32 scales, one row a sequence: each
    sequence's state (the leading dimension S of every tensor of
    ``stacked_states``) on its own frames, images (S, H, W, 3) or (S, N, H,
    W, 3); the maxes times float32(margin) in float32, the ``act_scales`` of
    ``OSVOS.forward``."""
    with span("int8.calibrate", device=True):
        first = next(iter(stacked_states.values()))
        x = _on(images, first)
        if x.dim() == 4:
            x = x[:, None]
        maxes = torch.stack([
            _calibration_maxes({k: v[s] for k, v in stacked_states.items()},
                               x[s], config)
            for s in range(first.shape[0])])
        return maxes * torch.tensor(margin, dtype=torch.float32,
                                    device=maxes.device)
