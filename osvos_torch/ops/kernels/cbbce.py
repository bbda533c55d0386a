"""Class-balanced BCE statistics and gradient (kernels B11-B14).

Counterpart of ``osvos_tpu/ops/pallas/cbbce.py``. Over (B, n) float32 logits
``x`` and labels, with z = 1{label >= 0.5} and
softplus(v) = max(v, 0) + log1p(exp(-|v|)):

- ``cbbce_stats``: (B, 4) = (n_pos, n_neg, sum z * softplus(-x),
  sum (1 - z) * softplus(x)) per sample;
- ``cbbce_grad``: dx = s * (w_pos * z * (sigmoid(x) - 1)
  + w_neg * (1 - z) * sigmoid(x)), with per-sample (w_pos, w_neg, s) read
  from the first three columns of a (B, 4) tensor on the same device.

The JAX package's whole-batch kernels (B11, B12) are these with the batch
viewed as one sample, (1, B * n). On a CUDA tensor each wrapper launches its
hand-written kernel from ``osvos_torch/csrc/cbbce.cu`` and counts the launch;
on a CPU tensor it runs the plain version (``*_ref``). There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from osvos_torch.ops.kernels.build import launch_stream

# Wrapper calls that launched the kernel in this process.
stats_launches = 0
grad_launches = 0

# The statistics kernel's block (kThreads), float4 pairs in flight per thread
# (kUnroll) and elements per tile (kChunk) in csrc/cbbce.cu.
STATS_THREADS = 512
STATS_UNROLL = 4
CHUNK = 4 * STATS_UNROLL * STATS_THREADS
# Counts are returned as float32, exact below 2^24.
MAX_ELEMENTS = 1 << 24


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return v.clamp_min(0) + torch.log1p(torch.exp(-v.abs()))


def cbbce_stats_ref(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``cbbce_stats``."""
    x = logits.float()
    z = (labels.float() >= 0.5).float()
    return torch.stack([z.sum(1), (1.0 - z).sum(1), (z * _softplus(-x)).sum(1),
                        ((1.0 - z) * _softplus(x)).sum(1)], dim=1)


def cbbce_grad_ref(logits: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``cbbce_grad``."""
    x = logits.float()
    z = (labels.float() >= 0.5).float()
    w_pos, w_neg, scale = (weights[:, i:i + 1] for i in range(3))
    sig = torch.sigmoid(x)
    return scale * (w_pos * z * (sig - 1.0) + w_neg * (1.0 - z) * sig)


def _check(name: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    for t in tensors:
        if (t.device != device or t.dtype != torch.float32 or t.dim() != 2
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: needs contiguous, 16-byte aligned 2-D float32 "
                f"tensors on one device; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}, contiguous={t.is_contiguous()}")


def stats_tiles(b: int, n: int) -> List[Tuple[int, int, int]]:
    """The statistics kernel's tile list: tile t is (sample, lo, hi), the
    elements [lo, hi) of sample t // chunks, chunk t % chunks, with chunks =
    ceil(n / CHUNK); its partial lands in slot t."""
    chunks = -(-n // CHUNK)
    return [(t // chunks, (t % chunks) * CHUNK, min((t % chunks + 1) * CHUNK, n))
            for t in range(b * chunks)]


def tile_order(lo: int, hi: int, misalign: int) -> np.ndarray:
    """(STATS_THREADS, 4 * STATS_UNROLL + 2) int64: the elements of [lo, hi)
    of a row that each thread of a tile sums, in its order, -1 for none:
    its float4 pairs of the tile's body, its head element (the scalar head
    runs up to a 16-byte boundary), its tail element. ``misalign`` is the
    row's first element's offset in floats past a 16-byte boundary, as
    ``Tile`` finds it from the address."""
    order = np.full((STATS_THREADS, 4 * STATS_UNROLL + 2), -1, np.int64)
    tid = np.arange(STATS_THREADS)
    mis = (misalign + lo) % 4
    head = min((4 - mis) % 4, hi - lo)
    body = lo + head
    n4 = (hi - body) // 4
    for u in range(STATS_UNROLL):
        i = tid + u * STATS_THREADS
        for e in range(4):
            order[:, 4 * u + e] = np.where(i < n4, body + 4 * i + e, -1)
    order[:, -2] = np.where(tid < head, lo + tid, -1)
    tail = body + 4 * n4 + tid
    order[:, -1] = np.where(tail < hi, tail, -1)
    return order


def cbbce_stats(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, 4) float32 statistics of (B, n) float32 logits and labels."""
    global stats_launches
    if logits.device.type == "cpu":
        return cbbce_stats_ref(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"cbbce_stats: no kernel for {logits.device}")
    _check("cbbce_stats", logits, labels)
    b, n = logits.shape
    if labels.shape != logits.shape or not 0 < n < MAX_ELEMENTS or b > 65535:
        raise ValueError(f"cbbce_stats: logits {tuple(logits.shape)} and "
                         f"labels {tuple(labels.shape)} must match, with "
                         f"0 < n < 2^24 and B <= 65535")
    # one allocation: out (b, 4), then the tiles' partials (b, chunks, 4)
    buf = torch.empty(4 * b * (1 + -(-n // CHUNK)), dtype=torch.float32,
                      device=logits.device)
    with launch_stream(logits.device) as stream:
        err = _entries()[0](logits.data_ptr(), labels.data_ptr(),
                            buf.data_ptr() + 16 * b, buf.data_ptr(), n, b,
                            stream)
    if err != 0:
        raise RuntimeError(f"cbbce_stats kernel launch failed: CUDA error {err}")
    stats_launches += 1
    return buf[:4 * b].view(b, 4)


def cbbce_grad(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 gradient; weights: (B, 4) rows of (w_pos, w_neg,
    scale, unused) on the logits' device."""
    global grad_launches
    if logits.device.type == "cpu":
        return cbbce_grad_ref(logits, labels, weights)
    if logits.device.type != "cuda":
        raise ValueError(f"cbbce_grad: no kernel for {logits.device}")
    _check("cbbce_grad", logits, labels, weights)
    b, n = logits.shape
    if labels.shape != logits.shape or weights.shape != (b, 4) or n < 1:
        raise ValueError(f"cbbce_grad: logits {tuple(logits.shape)}, labels "
                         f"{tuple(labels.shape)} and weights "
                         f"{tuple(weights.shape)} do not fit")
    dx = torch.empty_like(logits)
    with launch_stream(logits.device) as stream:
        err = _entries()[1](logits.data_ptr(), labels.data_ptr(),
                            weights.data_ptr(), dx.data_ptr(), n, b, stream)
    if err != 0:
        raise RuntimeError(f"cbbce_grad kernel launch failed: CUDA error {err}")
    grad_launches += 1
    return dx


@functools.lru_cache(maxsize=None)
def _entries():
    from osvos_torch.ops.kernels.build import load_library

    lib = load_library("cbbce")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    stats = lib.osvos_cbbce_stats
    stats.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
    stats.restype = ctypes.c_int
    grad = lib.osvos_cbbce_grad
    grad.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
    grad.restype = ctypes.c_int
    return stats, grad
