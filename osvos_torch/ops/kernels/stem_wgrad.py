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

``stem_wgrad_seq`` is the same function over S sequences in one launch,
for the packed schedule's grouped stem (``parallel/packed.py``): x (N, H,
W, S * C) and g (N, H, W, S * D) with sequence s in the channels
[s * C, (s + 1) * C) and [s * D, (s + 1) * D); dK (S, 3, 3, C, D), db
(S, D). The sequence is a grid axis, each sequence runs the plan of one
sequence's shape (``tma_plan``, ``plan``), so its result is bit for bit
``stem_wgrad`` on its slice. Its Hopper path keeps the lone strip, each
slot one image row of the block's own sequence: a gather warpgroup fills
it from the interleaved image (``gather_row`` mirrors where each value goes)
and the grid is sequence-major (``wgrad.seq_block``). Its launches count in
``seq_launches`` (and in ``tma_launches`` or ``mma_launches``), not in
``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched the kernel in this process (one image, and S
# sequences in one launch), and of them those on each path.
launches = 0
seq_launches = 0
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


def stem_wgrad_seq_ref(x: torch.Tensor, g: torch.Tensor, s: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``stem_wgrad_seq``: ``stem_wgrad_ref`` of each
    sequence's channel slice, stacked to (S, 3, 3, C, D) and (S, D)."""
    c, d = _seq_channels(x, g, s)
    outs = [stem_wgrad_ref(x[..., i * c:(i + 1) * c], g[..., i * d:(i + 1) * d])
            for i in range(s)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _seq_channels(x: torch.Tensor, g: torch.Tensor, s: int) -> Tuple[int, int]:
    """(C, D) of one sequence of x (N, H, W, S * C) and g (N, H, W, S * D);
    raises unless S divides both channel counts, N, H and W agree and C is
    an image's."""
    if s < 1 or x.dim() != 4 or g.dim() != 4 or x.shape[-1] % s \
            or g.shape[-1] % s:
        raise ValueError(f"stem_wgrad_seq: {s} sequences do not divide the "
                         f"channels of x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)}")
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"stem_wgrad_seq: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in N, H or W")
    c = x.shape[-1] // s
    if not 1 <= c <= MAX_C:
        raise ValueError(f"stem_wgrad_seq: takes 1 to {MAX_C} input channels "
                         f"a sequence, got {c}")
    return c, g.shape[-1] // s


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
    """Dynamic shared memory of a Hopper-path block (``tma_smem_bytes``):
    the same for one image and for S sequences."""
    return (1024 + STAGES * SEG * TILE_D * 2 + STACKED_TILES * SEG * 64
            + (SLOTS + 1) * slot_bytes(w, c) + 2 * (STAGES + SLOTS) * 8)


def gather_row(r: int, w: int, c: int, s: int, seq: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the sequence kernel's gather (``gather_rows``) puts image row
    r of sequence ``seq`` of an (N, H, w, s * c) image: (the byte offsets in
    the strip slot, the element indices of the interleaved tensor they take,
    -1 for the zero halo pixel either side). The offsets are the lone strip's
    for row r of the sequence's contiguous (N, H, w, c) slice: from its
    ``row_window`` lead on, one value every 2 bytes."""
    i = torch.arange(-c, (w + 1) * c)
    src = (r * w + i.div(c, rounding_mode="floor")) * s * c + seq * c + i % c
    src = torch.where((i >= 0) & (i < w * c), src, torch.full_like(src, -1))
    return row_window(r, w, c)[2] + 2 * i, src


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
    global launches
    if x.device.type == "cpu":
        return stem_wgrad_ref(x, g)
    _check(x, g, "stem_wgrad")
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"stem_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in N, H or W")
    if not 1 <= x.shape[-1] <= MAX_C:
        raise ValueError(f"stem_wgrad: takes 1 to {MAX_C} input channels, "
                         f"got {x.shape[-1]}")
    out = _launch(x, g, 1)
    launches += 1
    c, d = x.shape[-1], g.shape[-1]
    return out[0, :9 * c].view(3, 3, c, d), out[0, 9 * c]


def stem_wgrad_seq(x: torch.Tensor, g: torch.Tensor, s: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK (S, 3, 3, C, D), db (S, D)) float32 of S sequences whose channels
    are interleaved: the images x (N, H, W, S * C), C <= 3, and g (N, H, W,
    S * D). CPU tensors take the plain version; CUDA tensors launch the
    kernel once, the sequence a grid axis (module docstring)."""
    global seq_launches
    c, d = _seq_channels(x, g, s)
    if x.device.type == "cpu":
        return stem_wgrad_seq_ref(x, g, s)
    _check(x, g, "stem_wgrad_seq")
    out = _launch(x, g, s)
    seq_launches += 1
    return out[:, :9 * c].view(s, 3, 3, c, d), out[:, 9 * c]


def _check(x: torch.Tensor, g: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t in (x, g):
        if (t.device != x.device or t.dtype != torch.bfloat16 or t.dim() != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: x and g must be contiguous, 16-byte aligned NHWC "
                f"bfloat16 tensors on one device; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")


def _launch(x: torch.Tensor, g: torch.Tensor, s: int) -> torch.Tensor:
    """The kernel over ``s`` sequences (``s`` = 1: one image, whose strip the
    consumers cp.async on the Hopper path; more: the gather fills it);
    returns the (S, 9 C + 1, D) output, the db in row 9 C. Counts the
    path."""
    global tma_launches, mma_launches
    n, h, w, c = x.shape
    c, d = c // s, g.shape[-1] // s
    rows = 9 * c + 1
    runs = tma_plan(n, h, w, c, d)
    if runs is None:
        per_block, splits = plan(n, h, w, d)
    # each sequence's runs' or splits' (rows, D) float32 partials, and the
    # output
    partial = torch.empty((s, runs or splits, rows, d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((s, rows, d), dtype=torch.float32, device=x.device)
    with launch_stream(x.device) as stream:
        if runs is None:
            err = _entry("osvos_stem_wgrad")(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                n, h, w, c, d, s, per_block, splits, stream)
        else:
            err = _entry("osvos_stem_wgrad_tma")(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
                n, h, w, c, d, s, runs, stream)
    if err != 0:
        raise RuntimeError(f"stem_wgrad kernel launch failed "
                           f"({'tma' if runs else 'mma'} path): CUDA error {err}")
    if runs is not None:
        tma_launches += 1
    else:
        mma_launches += 1
    return out


_ARGTYPES = {
    "osvos_stem_wgrad": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
    "osvos_stem_wgrad_tma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                            + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from osvos_torch.ops.kernels.build import load_library

    fn = getattr(load_library("stem_wgrad"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
