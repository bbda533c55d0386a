"""osvos_torch: OSVOS one-shot video object segmentation in PyTorch and CUDA.

The port of ``osvos_tpu`` (JAX/Flax with Pallas kernels for the TPU) to one
NVIDIA H100. Module paths mirror ``osvos_tpu`` so that each module's
counterpart is easy to find; the JAX package stays the reference the port is
tested against, and the port itself imports no JAX.

What runs so far: parent training (``train.parent``, ``cli.train_parent``),
the one-shot online fine-tune (``train.online``) and per-frame inference
(``evaluation.infer``), with the VGG-16 OSVOS net in its 'parity', 'fast'
and 'flat' modes (``models``) and the hand-written CUDA kernels of
``ops.kernels`` (sources in ``csrc/``).
"""

__version__ = "0.1.0"

from osvos_torch.configs import (  # noqa: F401
    MEANVAL_BGR,
    DataConfig,
    ModelConfig,
    OnlineConfig,
    ParentConfig,
)
