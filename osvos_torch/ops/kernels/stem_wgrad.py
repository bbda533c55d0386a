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

On a CUDA tensor ``stem_wgrad`` launches the hand-written kernels of
``osvos_torch/csrc/stem_wgrad.cu`` and counts the launch; on a CPU tensor
it runs the plain version ``stem_wgrad_ref``. There is no fallback from one
to the other. The shape picks the path: the Hopper path (TMA ring of g, a
rolling image strip, wgmma; ``tma_launches``) for D a multiple of 8, the
first design (mma.sync; ``mma_launches``) otherwise. The flat stem's
backward (``ops/kernels/flatconv.stem_bwd``) and the fast trunk's
(``ops/fastconv``, dK only) both take it.

The schedule and the image strip that the Hopper path shares with the
stem's forward (``csrc/stem.cuh``) are mirrored here (``row_runs``,
``row_window``, ``slot_bytes``) so that the CPU tests can hold them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched the kernel in this process, and of them those
# on each path.
launches = 0
tma_launches = 0
mma_launches = 0

# Widest input the stacked operand takes: 9 * C taps and the ones column
# fit in its 32 rows.
MAX_C = 3
# Mma path: pixels of a row segment, the kernel's staged step.
_TW = 64
# Mma path: blocks the grid aims at, about 8 per SM of an H100, and the
# fewest segments a block is worth.
_TARGET_BLOCKS = 8 * 132
_MIN_SEGMENTS = 4

# csrc/stem.cuh and the Hopper path (csrc/stem_wgrad.cu): SMs of an H100,
# the pixels of a segment (one TMA box, one a thread), the channels of a
# box, the bytes a strip slot keeps before its first chunk, the ring's
# stages and stacked tiles, the strip's slots, shared memory a block can use.
NUM_SMS = 132
SEG = 128
TILE_D = 64
LEAD = 16
STAGES = 6
STACKED_TILES = 3
SLOTS = 4
SMEM_LIMIT = 227 * 1024


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
    """Mma path: (segments per block, blocks along the pixels), enough
    blocks that the grid has about ``_TARGET_BLOCKS``, none with fewer than
    ``_MIN_SEGMENTS`` row segments of 64 pixels."""
    segs = n * h * -(-w // _TW)
    d_tiles = -(-d // 64)
    per_block = max(_MIN_SEGMENTS, -(-segs * d_tiles // _TARGET_BLOCKS))
    return per_block, -(-segs // per_block)


# ---------------------------------------------------------------------------
# the schedule and the strip of csrc/stem.cuh
# ---------------------------------------------------------------------------


def row_runs(rows: int, blocks: int) -> List[Tuple[int, int]]:
    """The image rows [lo, hi) of each block of a persistent grid, as
    ``run_start``: block b takes [rows * b // blocks, rows * (b + 1) //
    blocks)."""
    return [(rows * b // blocks, rows * (b + 1) // blocks) for b in range(blocks)]


def row_window(r: int, w: int, c: int) -> Tuple[int, int, int]:
    """(a0, chunks, lead) of image row r of an (N, H, w, c) bf16 tensor, as
    ``row_window``: the 16-byte chunks from byte a0 that cover the row's
    bytes, and the slot offset at which its first pixel lands."""
    row_bytes = 2 * w * c
    b0 = r * row_bytes
    a0 = b0 & ~15
    return a0, (b0 + row_bytes - a0 + 15) >> 4, LEAD + (b0 & 15)


def slot_bytes(w: int, c: int) -> int:
    """Bytes of a strip slot: the row, its chunks' slack and the halo."""
    return -(-(2 * w * c + 64) // 16) * 16


def tma_smem(w: int, c: int) -> int:
    """Dynamic shared memory of a Hopper-path block (``tma_smem_bytes``)."""
    return (1024 + STAGES * SEG * TILE_D * 2 + STACKED_TILES * SEG * 64
            + (SLOTS + 1) * slot_bytes(w, c) + 2 * STAGES * 8)


def tma_plan(n: int, h: int, w: int, c: int, d: int) -> Optional[int]:
    """The runs of image rows a 64-channel tile of the Hopper path takes
    (one block each; a block per SM in all, or one per image row where there
    are fewer), or None where the mma path takes the shape: D off a multiple
    of 8 (TMA's 16-byte strides), or a row too wide for the strip."""
    if not 1 <= c <= MAX_C or d % 8 or tma_smem(w, c) > SMEM_LIMIT:
        return None
    return min(NUM_SMS // -(-d // TILE_D), n * h) or None


def stem_wgrad(x: torch.Tensor, g: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK (3, 3, C, D), db (D,)) float32 of the image x (N, H, W, C <= 3)
    and g (N, H, W, D). CPU tensors take the plain version; CUDA tensors
    launch the kernel, which needs contiguous bf16 operands."""
    global launches, tma_launches, mma_launches
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
    rows = 9 * c + 1
    runs = tma_plan(n, h, w, c, d)
    if runs is None:
        per_block, splits = plan(n, h, w, d)
    # each run's or split's (rows, D) float32 partial, and the output
    partial = torch.empty((runs or splits, rows, d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    with launch_stream(x.device) as stream:
        if runs is None:
            err = _entry("osvos_stem_wgrad")(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                n, h, w, c, d, per_block, splits, stream)
        else:
            err = _entry("osvos_stem_wgrad_tma")(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                n, h, w, c, d, runs, stream)
    if err != 0:
        raise RuntimeError(f"stem_wgrad kernel launch failed "
                           f"({'tma' if runs else 'mma'} path): CUDA error {err}")
    launches += 1
    if runs is not None:
        tma_launches += 1
    else:
        mma_launches += 1
    return out[:9 * c].view(3, 3, c, d), out[9 * c]


_ARGTYPES = {
    "osvos_stem_wgrad": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
    "osvos_stem_wgrad_tma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from osvos_torch.ops.kernels.build import load_library

    fn = getattr(load_library("stem_wgrad"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
