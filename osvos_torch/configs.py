"""Configuration dataclasses of the port.

The same fields and defaults as ``osvos_tpu/configs.py`` (ModelConfig,
DataConfig, OnlineConfig, MEANVAL_BGR), restated so that nothing in the port
imports the JAX package. ``tests/test_torch_hygiene.py`` holds the two
definitions equal field by field, so they cannot drift apart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Caffe-era BGR channel means subtracted by the reference loader; no std
# scaling.
MEANVAL_BGR: Tuple[float, float, float] = (104.00699, 116.66877, 122.67892)


@dataclasses.dataclass
class ModelConfig:
    """OSVOS network (VGG-16 trunk, four side branches, fuse head)."""

    # Per-stage conv widths; ceil-mode 2x2/2 pooling precedes stages 2-5.
    stages: Tuple[Tuple[int, ...], ...] = ((64, 64), (128, 128), (256, 256, 256),
                                           (512, 512, 512), (512, 512, 512))
    side_channels: int = 16
    # 'parity': float32 with TF32 off. 'fast': bf16 trunk, f32 params and
    # heads. 'flat' and 'int8' exist in the JAX package only so far.
    compute_mode: str = "parity"
    fast_conv_vjp: bool = True
    int8_scales: Optional[Tuple[float, ...]] = None
    trainable_upsample: bool = False
    flat_side: str = "stacked"


@dataclasses.dataclass
class DataConfig:
    """DAVIS-2016 loading."""

    year: str = "2016"
    resolution: str = "480p"
    input_res: Optional[Tuple[int, int]] = None  # (H, W) resize; None = native
    meanval: Tuple[float, float, float] = MEANVAL_BGR
    rots: Tuple[float, float] = (-30.0, 30.0)
    scales: Tuple[float, float] = (0.75, 1.25)
    hflip_prob: float = 0.5


@dataclasses.dataclass
class OnlineConfig:
    """One-shot online fine-tuning."""

    seq_name: str = "blackswan"
    n_ave_grad: int = 5
    n_steps: int = 2000
    lr: float = 1e-8
    weight_decay: float = 0.0002
    momentum: float = 0.9
    seed: int = 0
    rots: Tuple[float, float] = (-30.0, 30.0)
    scales: Tuple[float, float] = (0.75, 1.25)
    hflip_prob: float = 0.5
    save_results: bool = True
    vis_res: bool = False
    loss_impl: str = "xla"
    scan_chunk: int = 250
