"""osvos_torch: OSVOS one-shot video object segmentation in PyTorch and CUDA.

The port of ``osvos_tpu`` (JAX/Flax with Pallas kernels for the TPU) to one
NVIDIA H100. Module paths mirror ``osvos_tpu`` so that each module's
counterpart is easy to find; the JAX package stays the reference the port is
tested against, and the port itself imports no JAX.

What runs so far is the serving path: per-frame inference over a sequence
with given weights (``evaluation.infer``), the VGG-16 OSVOS net in its
'parity' and 'fast' modes (``models``), and the fused-head tail as a CUDA
kernel (``ops.kernels.fused_head``, source in ``csrc/``).
"""

__version__ = "0.1.0"

from osvos_torch.configs import (  # noqa: F401
    MEANVAL_BGR,
    DataConfig,
    ModelConfig,
    OnlineConfig,
)
