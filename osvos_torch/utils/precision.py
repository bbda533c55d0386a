"""Full float32 precision for a block of code, without flipping global flags.

On the card, cuDNN runs float32 convolutions in TF32 by default, which keeps
about three decimal digits and would break the parity tolerance (2e-4 of the
output's scale). ``exact_f32`` turns TF32 off for cuDNN and for matmul
inside the block and restores both settings on exit. On the CPU neither
setting has an effect.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    cudnn = torch.backends.cudnn
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)
