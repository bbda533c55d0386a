"""Fused upsample + crop + sum + bias + sigmoid -> uint8 tail of inference.

After the fused-head collapse (``OSVOS(mode='infer_parts')``) each frame
leaves four low-resolution contribution maps ``c_i`` and the fuse bias. This
module turns them into the (B, H, W) uint8 map
``rint(255 * sigmoid(bias + sum_i Uh_i . c_i . Uw_i^T))``, where ``Uh_i`` and
``Uw_i`` are the bilinear interpolation matrices with the center crop folded
in (``_cropped_interp``).

Counterpart of ``osvos_tpu/ops/pallas/fused_head.py``. On a CUDA tensor
``fused_upsample_sigmoid_u8`` launches the hand-written kernel of
``osvos_torch/csrc/fused_head.cu``; on a CPU tensor it runs the plain
version ``fused_upsample_sigmoid_u8_ref``. There is no fallback from one to
the other. Each row of ``Uh_i`` and ``Uw_i`` has at most two nonzeros;
``two_tap_table`` states them as the kernel computes them, and ``row_runs``,
``pieces``, ``source_span`` and ``thread_columns`` state how the kernel
divides the work, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.ops.upsample import _bilinear_filter_1d, _interp_matrix
from osvos_torch.utils.precision import exact_f32

# Kernel launches made by fused_upsample_sigmoid_u8 in this process.
launches = 0

_MAX_SCALES = 4
# Threads of a block of csrc/fused_head.cu's tail_kernel (kThreads): thread t
# blends source column t and sums output column t, then every THREADS past.
THREADS = 1024
# Most rows of a piece (kMaxRun): a block stages the source rows of a piece
# of its run in shared memory at once.
MAX_RUN = 16


def crop_top(n_in: int, factor: int, n_out: int) -> int:
    """The first row of the full transposed-conv map of ``n_in`` rows at
    ``factor`` ((n_in + 1) * factor rows) that the reference center crop to
    ``n_out`` rows keeps."""
    full = (n_in + 1) * factor
    top = (full - n_out) // 2
    if not 0 <= top <= full - n_out:
        raise ValueError(f"cannot crop {full} rows to {n_out}")
    return top


@functools.lru_cache(maxsize=None)
def _cropped_interp(n_in: int, factor: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix with the reference center crop
    folded in: rows [top : top + n_out] of the full transposed-conv matrix,
    top = ``crop_top``."""
    top = crop_top(n_in, factor, n_out)
    return np.ascontiguousarray(_interp_matrix(n_in, factor)[top:top + n_out])


@functools.lru_cache(maxsize=None)
def _device_interp(n_in: int, factor: int, n_out: int,
                   device: torch.device) -> torch.Tensor:
    """``_cropped_interp`` as a tensor kept on ``device``; read only."""
    return torch.from_numpy(_cropped_interp(n_in, factor, n_out)).to(device)


@functools.lru_cache(maxsize=None)
def two_tap_table(n_in: int, factor: int,
                  n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """``_cropped_interp`` as a gather table: ``idx`` (n_out, 2) int32 and
    ``w`` (n_out, 2) float32 with ``m[o, idx[o, k]] == w[o, k]`` and every
    other entry of row ``o`` zero, as the kernel's ``tap_of`` computes them:
    output o reads sources (o + top) // factor - 1 and (o + top) // factor
    that lie in [0, n_in), in order, weighted by the bilinear filter of
    length 2 * factor; a lone source repeats with weight 0."""
    u = np.arange(n_out) + crop_top(n_in, factor, n_out)
    i1 = u // factor
    i0 = i1 - 1
    k1d = _bilinear_filter_1d(2 * factor)
    w0, w1 = k1d[u - i0 * factor], k1d[u - i1 * factor]
    in0, in1 = (i0 >= 0) & (i0 < n_in), i1 < n_in
    both = in0 & in1
    idx = np.stack([np.where(in0, i0, i1), np.where(in1, i1, i0)], 1)
    w = np.stack([np.where(in0, w0, w1), np.where(both, w1, 0)], 1)
    lone = ~in0 & ~in1
    idx[lone], w[lone] = 0, 0
    return idx.astype(np.int32), w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _launch_args(shapes: Tuple[Tuple[int, int], ...], factors: Tuple[int, ...],
                 out_hw: Tuple[int, int]) -> tuple:
    """The entry point's arguments that depend only on the shapes: the
    scales' (h, w), factors, and the crop's first row and column of each
    full map, each padded to four, and the scale count."""
    n = len(shapes)
    pad = [0] * (_MAX_SCALES - n)
    dims = [d for s in shapes for d in s] + pad + pad
    h, w = out_hw
    tops_h = [crop_top(hi, f, h) for (hi, _), f in zip(shapes, factors)]
    tops_w = [crop_top(wi, f, w) for (_, wi), f in zip(shapes, factors)]
    return (*dims, *factors, *pad, *tops_h, *pad, *tops_w, *pad, n)


def row_runs(rows: int, blocks: int) -> List[Tuple[int, int]]:
    """The flat output rows [lo, hi) of each block of the kernel's
    persistent grid: block g takes [rows * g // blocks, rows * (g + 1) //
    blocks), as ``tail_kernel`` does."""
    return [(rows * g // blocks, rows * (g + 1) // blocks) for g in range(blocks)]


def pieces(lo: int, hi: int, h: int, run: int = MAX_RUN) -> List[Tuple[int, int]]:
    """The pieces [p0, p1) a block takes its rows [lo, hi) of the flat
    (B * h) output in, as ``tail_kernel`` does: at most ``run`` rows, in at
    most two frames."""
    out = []
    while lo < hi:
        p1 = min(lo + run, hi, lo - lo % h + 2 * h)
        out.append((lo, p1))
        lo = p1
    return out


def source_span(o0: int, o1: int, n_in: int, factor: int,
                top: int) -> Tuple[int, int]:
    """The source rows [lo, hi] that output rows o0..o1 of a frame read,
    as the kernel's ``span`` finds them: row o reads rows (o + top) //
    factor - 1 and (o + top) // factor, clipped to the map."""
    return (max((o0 + top) // factor - 1, 0), min((o1 + top) // factor, n_in - 1))


def thread_columns(tid: int, w: int) -> range:
    """The output columns (and, over the concatenated scales' source
    columns, the blended columns) thread ``tid`` of a block takes: ``tid``,
    then every ``THREADS`` past it."""
    return range(tid, w, THREADS)


def tail_logits_ref(contribs: Sequence[torch.Tensor], bias: torch.Tensor,
                    out_hw: Tuple[int, int],
                    factors: Sequence[int]) -> torch.Tensor:
    """(B, H, W) float32 logits: the dense ``Uh @ c @ Uw^T`` per scale in f32
    (TF32 off), summed, plus the bias."""
    h, w = out_hw
    acc = None
    with exact_f32():
        for c, f in zip(contribs, factors):
            uh = _device_interp(c.shape[1], f, h, c.device)
            uw = _device_interp(c.shape[2], f, w, c.device)
            term = uh @ c.float() @ uw.T
            acc = term if acc is None else acc + term
    return acc + bias.float().reshape(())


def fused_upsample_sigmoid_u8_ref(contribs: Sequence[torch.Tensor],
                                  bias: torch.Tensor, out_hw: Tuple[int, int],
                                  factors: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version: ``tail_logits_ref``, sigmoid, ``torch.round``
    and the uint8 cast. Counterpart of the XLA tail of
    ``osvos_tpu/evaluation/infer.py``."""
    probs = torch.sigmoid(tail_logits_ref(contribs, bias, out_hw, factors))
    return torch.round(255.0 * probs).to(torch.uint8)


def fused_upsample_sigmoid_u8(contribs: Sequence[torch.Tensor],
                              bias: torch.Tensor, out_hw: Tuple[int, int],
                              factors: Sequence[int]) -> torch.Tensor:
    """(B, H, W) uint8 = round(255 * sigmoid(sum_i upsample_crop(c_i) + bias)).

    contribs: per scale a (B, h_i, w_i) float32 tensor; bias: a one-element
    float32 tensor; factors: the upsampling factor of each scale. CPU tensors
    take the plain version; CUDA tensors launch the kernel, and anything the
    kernel does not take raises.
    """
    global launches
    device = contribs[0].device
    if device.type == "cpu":
        return fused_upsample_sigmoid_u8_ref(contribs, bias, out_hw, factors)
    if device.type != "cuda":
        raise ValueError(f"fused_upsample_sigmoid_u8: no kernel for {device}")
    n = len(contribs)
    if not 1 <= n <= _MAX_SCALES or len(factors) != n:
        raise ValueError(f"need 1..{_MAX_SCALES} scales with one factor "
                         f"each, got {n} and {len(factors)}")
    b = contribs[0].shape[0]
    for c in contribs:
        if (c.device != device or c.dtype != torch.float32 or c.dim() != 3
                or c.shape[0] != b or not c.is_contiguous()):
            raise ValueError("contributions must be contiguous (B, h, w) "
                             f"float32 on {device}; got {c.dtype} "
                             f"{tuple(c.shape)} on {c.device}")
    if bias.device != device or bias.dtype != torch.float32 or bias.numel() != 1:
        raise ValueError("bias must be one float32 element on the same device")
    h, w = out_hw
    shapes = tuple((int(c.shape[1]), int(c.shape[2])) for c in contribs)
    static = _launch_args(shapes, tuple(int(f) for f in factors),
                          (int(h), int(w)))
    out = torch.empty((b, h, w), dtype=torch.uint8, device=device)
    ptrs = [c.data_ptr() for c in contribs] + [None] * (_MAX_SCALES - n)
    with launch_stream(device) as stream:
        err = _entry()(*ptrs, *static, bias.data_ptr(), out.data_ptr(), b, h,
                       w, stream)
    if err != 0:
        raise RuntimeError(f"fused_head tail kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    from osvos_torch.ops.kernels.build import load_library

    fn = load_library("fused_head").osvos_fused_head_tail_u8
    fn.argtypes = ([ctypes.c_void_p] * _MAX_SCALES
                   + [ctypes.c_int] * (5 * _MAX_SCALES + 1)
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
