"""Weight and bias gradient of the 3x3 SAME stem conv (kernel B16).

Counterpart of ``osvos_tpu/ops/pallas/flatconv.py:_stem_wgrad_kernel``: for
the NHWC bf16 image ``x`` (N, H, W, C) with C <= 3 and the cotangent ``g``
(N, H, W, D),

    dK[kh, kw, c, d] = sum_{n, h, w} x[n, h + kh - 1, w + kw - 1, c] * g[n, h, w, d]
    db[d]            = sum_{n, h, w} g[n, h, w, d]

with x outside the image taken as zero, as a (3, 3, C, D) and a (D,)
float32 tensor: bf16 products summed in float32. The nine taps x C
channels of each pixel are stacked into one K = 9 C operand, so the whole
function is one product over the pixels.

On a CUDA tensor ``stem_wgrad`` launches the hand-written kernel of
``osvos_torch/csrc/stem_wgrad.cu`` and counts the launch; on a CPU tensor
it runs the plain version ``stem_wgrad_ref``. There is no fallback from one
to the other. The flat stem's backward (``ops/kernels/flatconv.stem_bwd``)
and the fast trunk's (``ops/fastconv``, dK only) both take it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched the kernel in this process.
launches = 0

# Widest input the stacked operand takes: 9 * C taps and the ones column
# fit in its 32 rows.
MAX_C = 3
# Pixels of a row segment, the kernel's staged step.
_TW = 64
# Blocks the grid aims at: about 8 per SM of an H100.
_TARGET_BLOCKS = 8 * 132
# Fewest segments a block is worth.
_MIN_SEGMENTS = 4


def stem_wgrad_ref(x: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the 9 C im2col columns of the bf16 image as a
    float32 (N H W, 9 C) matrix X, dK = X^T @ G with TF32 off, and db the
    float32 column sums of g."""
    n, h, w, c = x.shape
    d = g.shape[-1]
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, kh:kh + h, kw:kw + w, :]
                      for kh in range(3) for kw in range(3)], dim=-1)
    gf = g.to(torch.bfloat16).float().reshape(-1, d)
    with exact_f32():
        dk = cols.reshape(-1, 9 * c).T @ gf
    return dk.reshape(3, 3, c, d), gf.sum(0)


def plan(n: int, h: int, w: int, d: int) -> Tuple[int, int]:
    """(segments per block, blocks along the pixels): enough blocks that
    the grid has about ``_TARGET_BLOCKS``, none with fewer than
    ``_MIN_SEGMENTS`` row segments of 64 pixels."""
    segs = n * h * -(-w // _TW)
    d_tiles = -(-d // 64)
    per_block = max(_MIN_SEGMENTS, -(-segs * d_tiles // _TARGET_BLOCKS))
    return per_block, -(-segs // per_block)


def stem_wgrad(x: torch.Tensor, g: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK (3, 3, C, D), db (D,)) float32 of the image x (N, H, W, C <= 3)
    and g (N, H, W, D). CPU tensors take the plain version; CUDA tensors
    launch the kernel, which needs contiguous bf16 operands."""
    global launches
    if x.device.type == "cpu":
        return stem_wgrad_ref(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"stem_wgrad: no kernel for {x.device}")
    for t in (x, g):
        if (t.device != x.device or t.dtype != torch.bfloat16 or t.dim() != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                "stem_wgrad: x and g must be contiguous, 16-byte aligned NHWC "
                f"bfloat16 tensors on one device; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    n, h, w, c = x.shape
    d = g.shape[-1]
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"stem_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in N, H or W")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"stem_wgrad: takes 1 to {MAX_C} input channels, "
                         f"got {c}")
    per_block, splits = plan(n, h, w, d)
    rows = 9 * c + 1
    partial = torch.empty((splits, rows, d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                       out.data_ptr(), n, h, w, c, d, per_block, splits,
                       stream)
    if err != 0:
        raise RuntimeError(f"stem_wgrad kernel launch failed: CUDA error {err}")
    launches += 1
    return out[:9 * c].view(3, 3, c, d), out[9 * c]


@functools.lru_cache(maxsize=None)
def _entry():
    from osvos_torch.ops.kernels.build import load_library

    fn = load_library("stem_wgrad").osvos_stem_wgrad
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
