"""Weight gradient of a 3x3 SAME convolution (kernel B17).

Counterpart of ``osvos_tpu/ops/pallas/wgrad.py``: for NHWC bf16 ``x``
(N, H, W, C) and cotangent ``g`` (N, H, W, D),

    dK[kh, kw, c, d] = sum_{n, h, w} x[n, h + kh - 1, w + kw - 1, c] * g[n, h, w, d]

with x outside the image taken as zero, as a (3, 3, C, D) float32 tensor:
bf16 products summed in float32, the function that
``osvos_tpu/ops/fastconv.py:_wgrad_einsum`` computes.

On a CUDA tensor ``wgrad3x3`` launches the hand-written kernel of
``osvos_torch/csrc/wgrad.cu`` and counts the launch; on a CPU tensor it runs
the plain version ``wgrad3x3_ref``. There is no fallback from one to the
other.

``launch`` is the same kernel without the count, optionally with the bias
gradient db = sum over pixels of g as a second output; the flat trunk's
backward wrappers (``ops/kernels/flatconv.py``, B3, B4 and B6) call it and
count their own launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched the kernel in this process.
launches = 0

# Pixel rows per staged step of the kernel; a chunk is a multiple of it.
_TK = 32
# Blocks the grid aims at: about 16 per SM of an H100.
_TARGET_BLOCKS = 16 * 132
# Fewest pixels a chunk is worth.
_MIN_CHUNK = 512


def wgrad3x3_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nine shifted [NHW, C]^T @ [NHW, D] products of
    the bf16 values in float32, TF32 off."""
    n, h, w, c = x.shape
    d = g.shape[-1]
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    gf = g.to(torch.bfloat16).float().reshape(-1, d)
    taps = []
    with exact_f32():
        for kh in range(3):
            for kw in range(3):
                xs = xp[:, kh:kh + h, kw:kw + w, :].reshape(-1, c)
                taps.append(xs.T @ gf)
    return torch.stack(taps).reshape(3, 3, c, d)


def plan(n: int, h: int, w: int, c: int, d: int) -> Tuple[int, int, int]:
    """(tile_c, splits, chunk) for the kernel: a 16-row C tile for narrow
    inputs, and enough pixel chunks (split-K) that the grid has about
    ``_TARGET_BLOCKS`` blocks, none with fewer than ``_MIN_CHUNK`` pixels."""
    pixels = n * h * w
    tile_c = 16 if c <= 16 else 64
    tiles = 9 * -(-c // tile_c) * -(-d // 64)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-pixels // _MIN_CHUNK)))
    chunk = -(-pixels // splits)
    chunk = -(-chunk // _TK) * _TK
    return tile_c, -(-pixels // chunk), chunk


def wgrad3x3(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, D) float32 weight gradient of x (N, H, W, C) and g
    (N, H, W, D). CPU tensors take the plain version; CUDA tensors launch
    the kernel, which needs contiguous bf16 operands."""
    global launches
    if x.device.type == "cpu":
        return wgrad3x3_ref(x, g)
    dk, _ = launch(x, g, with_db=False)
    launches += 1
    return dk


def launch(x: torch.Tensor, g: torch.Tensor, with_db: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel on CUDA tensors, uncounted: (dK, db), db the (D,) float32
    column sum of g when ``with_db``, else None."""
    if x.device.type != "cuda":
        raise ValueError(f"wgrad3x3: no kernel for {x.device}")
    for t in (x, g):
        if (t.device != x.device or t.dtype != torch.bfloat16 or t.dim() != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                "wgrad3x3: x and g must be contiguous, 16-byte aligned NHWC "
                f"bfloat16 tensors on one device; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    n, h, w, c = x.shape
    d = g.shape[-1]
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"wgrad3x3: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in N, H or W")
    tile_c, splits, chunk = plan(n, h, w, c, d)
    size = 9 * c * d + (d if with_db else 0)
    partial = torch.empty((splits, size), dtype=torch.float32, device=x.device)
    out = torch.empty(size, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                       out.data_ptr(), n, h, w, c, d, tile_c, splits, chunk,
                       int(with_db), stream)
    if err != 0:
        raise RuntimeError(f"wgrad3x3 kernel launch failed: CUDA error {err}")
    dk = out[:9 * c * d].view(3, 3, c, d)
    return dk, (out[9 * c * d:] if with_db else None)


@functools.lru_cache(maxsize=None)
def _entry():
    from osvos_torch.ops.kernels.build import load_library

    fn = load_library("wgrad").osvos_wgrad3x3
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
