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
the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from osvos_torch.ops.upsample import _interp_matrix
from osvos_torch.utils.precision import exact_f32

# Kernel launches made by fused_upsample_sigmoid_u8 in this process.
launches = 0

_MAX_SCALES = 4


@functools.lru_cache(maxsize=None)
def _cropped_interp(n_in: int, factor: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix with the reference center crop
    folded in: rows [top : top + n_out] of the full transposed-conv matrix,
    top = (full - n_out) // 2."""
    full = _interp_matrix(n_in, factor)
    top = (full.shape[0] - n_out) // 2
    if not 0 <= top <= full.shape[0] - n_out:
        raise ValueError(f"cannot crop {full.shape} to {n_out} rows")
    return np.ascontiguousarray(full[top:top + n_out])


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
    other entry of row ``o`` zero. A row with one nonzero repeats its index
    with weight 0. Raises if a row has more than two nonzeros."""
    m = _cropped_interp(n_in, factor, n_out)
    idx = np.zeros((n_out, 2), np.int32)
    w = np.zeros((n_out, 2), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(m[o])
        if len(nz) > 2:
            raise ValueError(f"row {o} of the ({n_in}, x{factor}) matrix has "
                             f"{len(nz)} nonzeros; the kernel gathers two")
        if len(nz) == 0:
            continue
        idx[o] = (nz[0], nz[-1])
        w[o, 0] = m[o, nz[0]]
        if len(nz) == 2:
            w[o, 1] = m[o, nz[1]]
    return idx, w


@functools.lru_cache(maxsize=None)
def _device_tables(shapes: Tuple[Tuple[int, int], ...],
                   factors: Tuple[int, ...], out_hw: Tuple[int, int],
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(row_idx, row_w, col_idx, col_w) for all scales, stacked to
    (n_scales, H, 2) / (n_scales, W, 2) and kept on ``device``."""
    h, w = out_hw
    rows = [two_tap_table(hi, f, h) for (hi, _), f in zip(shapes, factors)]
    cols = [two_tap_table(wi, f, w) for (_, wi), f in zip(shapes, factors)]
    return tuple(torch.from_numpy(np.stack(a)).to(device) for a in (
        [r[0] for r in rows], [r[1] for r in rows],
        [c[0] for c in cols], [c[1] for c in cols]))


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
    tables = _device_tables(shapes, tuple(int(f) for f in factors),
                            (int(h), int(w)), device)
    out = torch.empty((b, h, w), dtype=torch.uint8, device=device)
    ptrs = [c.data_ptr() for c in contribs] + [None] * (_MAX_SCALES - n)
    dims = [d for s in shapes for d in s] + [0] * (2 * (_MAX_SCALES - n))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry()(*ptrs, *dims, n, *(t.data_ptr() for t in tables),
                       bias.data_ptr(), out.data_ptr(), b, h, w, stream)
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
                   + [ctypes.c_int] * (2 * _MAX_SCALES + 1)
                   + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
