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

The source has two paths, and the shape picks one (``plan``): the Hopper
path (TMA, an mbarrier ring and wgmma; ``tma_launches``) for C and D
multiples of 8, which every trunk and side conv is, and the first wmma
design (``wmma_launches``) for the rest, whose rows TMA cannot describe.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched the kernel in this process.
launches = 0
# Launches of each path of csrc/wgrad.cu, whoever called (B17, B4, B6).
tma_launches = 0
wmma_launches = 0

# SMs of an H100; the Hopper path runs one block on each.
NUM_SMS = 132
# Channels of C in a block tile of the Hopper path.
TMA_TILE_C = 64
# wmma path: pixel rows per staged step (a chunk is a multiple of it), the
# blocks its grid aims at (about 16 per SM) and the fewest pixels a chunk is
# worth.
_TK = 32
_TARGET_BLOCKS = 16 * NUM_SMS
_MIN_CHUNK = 512


class Plan(NamedTuple):
    """How csrc/wgrad.cu runs one shape.

    ``path`` is 'tma' or 'wmma'. Hopper path: a block tile of ``tile_c`` x
    ``tile_d`` (C, D) channels, K-steps of ``step`` pixels of one image row
    (``units`` of them per tile, ``tiles`` tiles), ``blocks`` blocks taking
    contiguous runs of the tile-major K-steps. wmma path: ``tile_c`` x 64
    tiles, ``blocks`` pixel chunks (splits) of ``chunk`` pixels."""
    path: str
    tile_c: int
    tile_d: int
    step: int
    blocks: int
    units: int = 0
    tiles: int = 0
    chunk: int = 0

    @property
    def total(self) -> int:
        return self.units * self.tiles

    def block_range(self, b: int) -> Tuple[int, int]:
        """The K-steps [start, end) of the Hopper path's block ``b``."""
        return b * self.total // self.blocks, (b + 1) * self.total // self.blocks

    def blocks_of_tile(self, t: int) -> Tuple[int, int]:
        """The first and last block whose run meets tile ``t``, as the
        kernel's second pass computes them; it adds pieces b + t in order."""
        lo = -(-(t * self.units + 1) * self.blocks // self.total) - 1
        hi = -(-(t + 1) * self.units * self.blocks // self.total) - 1
        return lo, min(hi, self.blocks - 1)

    @property
    def pieces(self) -> int:
        """Partial tiles of the Hopper path's first pass."""
        return self.blocks + self.tiles - 1

    @property
    def piece(self) -> int:
        """float32 values of one piece: nine taps' tile and the db row."""
        return 9 * self.tile_c * self.tile_d + self.tile_d


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


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, c: int, d: int) -> Plan:
    """The path and its tiling for x (n, h, w, c) and g (n, h, w, d).

    C and D multiples of 8 (16-byte rows, as TMA needs) take the Hopper
    path: 64 x 64 tiles, or 64 x 16 for D <= 16; K-steps of 32 or 64 pixels,
    whichever pads a row of w less (64 on a tie); one block per SM, or one
    per K-step when there are fewer. Other shapes take the wmma path: a
    16-row C tile for narrow inputs, and enough pixel chunks (split-K) that
    the grid has about ``_TARGET_BLOCKS`` blocks, none with fewer than
    ``_MIN_CHUNK`` pixels."""
    if c % 8 == 0 and d % 8 == 0:
        tile_d = 16 if d <= 16 else 64
        step = 32 if -(-w // 32) * 32 < -(-w // 64) * 64 else 64
        units = n * h * -(-w // step)
        tiles = -(-c // TMA_TILE_C) * -(-d // tile_d)
        return Plan("tma", TMA_TILE_C, tile_d, step,
                    min(NUM_SMS, units * tiles), units, tiles)
    pixels = n * h * w
    tile_c = 16 if c <= 16 else 64
    tiles = 9 * -(-c // tile_c) * -(-d // 64)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-pixels // _MIN_CHUNK)))
    chunk = -(-pixels // splits)
    chunk = -(-chunk // _TK) * _TK
    return Plan("wmma", tile_c, 64, _TK, -(-pixels // chunk), chunk=chunk)


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
    """The kernel on CUDA tensors, uncounted by the callers' counts: (dK,
    db), db the (D,) float32 column sum of g when ``with_db``, else None.
    Counts the launch in ``tma_launches`` or ``wmma_launches``."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"wgrad3x3: no kernel for {device}")
    for t in (x, g):
        if (t.device != device or t.dtype != torch.bfloat16 or t.dim() != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                "wgrad3x3: x and g must be contiguous, 16-byte aligned NHWC "
                f"bfloat16 tensors on one device; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"wgrad3x3: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in N, H or W")
    return launch_checked(x, g, with_db)


def launch_checked(x: torch.Tensor, g: torch.Tensor, with_db: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``launch`` for x and g that the caller has checked as ``launch``
    does (the flat side backward checks them first). The split-K scratch
    and the outputs share one allocation, one allocator call fewer: dK and
    db are views of it, so the scratch lives as long as they do (the
    autograd functions hand dK on as a permuted view, which the gradient
    accumulation copies)."""
    global tma_launches, wmma_launches
    device = x.device
    n, h, w, c = x.shape
    d = g.shape[-1]
    p = plan(n, h, w, c, d)
    size = 9 * c * d + (d if with_db else 0)
    # the scratch first, rounded up to 4 floats so the outputs start
    # 16-byte aligned
    scratch = -(-(p.pieces * p.piece if p.path == "tma" else p.blocks * size)
                // 4) * 4
    buf = torch.empty(scratch + size, dtype=torch.float32, device=device)
    partial, out = buf.data_ptr(), buf.data_ptr() + 4 * scratch
    with launch_stream(device) as stream:
        if p.path == "tma":
            err = _entry("osvos_wgrad3x3_tma")(
                x.data_ptr(), g.data_ptr(), partial, out, n, h, w, c, d,
                p.tile_d, p.step, p.blocks, int(with_db), stream)
        else:
            err = _entry("osvos_wgrad3x3")(
                x.data_ptr(), g.data_ptr(), partial, out, n, h, w, c, d,
                p.tile_c, p.blocks, p.chunk, int(with_db), stream)
    if err != 0:
        raise RuntimeError(f"wgrad3x3 kernel ({p.path} path) launch failed: "
                           f"error {err}")
    if p.path == "tma":
        tma_launches += 1
    else:
        wmma_launches += 1
    dk = buf[scratch:scratch + 9 * c * d].view(3, 3, c, d)
    return dk, (buf[scratch + 9 * c * d:] if with_db else None)


_ARGTYPES = {
    "osvos_wgrad3x3_tma": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                          + [ctypes.c_void_p],
    "osvos_wgrad3x3": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from osvos_torch.ops.kernels.build import load_library

    fn = getattr(load_library("wgrad"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
