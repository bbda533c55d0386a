"""The stage-boundary max pool and its backward (kernels B7-B10).

Counterparts of the TPU kernels of ``osvos_tpu/ops/pallas/flatpool.py``:
the flat pool (B7 forward, B8 backward) and the pool of the
pixel-pair-packed stage-1 buffer (B9, B10). The four compute one function;
the flat buffers and the packing are TPU layouts (ROADMAP.md), so on the
port's contiguous NHWC tensors they are one forward and one backward kernel:

- ``max_pool_fwd``: the ceil-mode 2x2 stride-2 max pool, (N, H, W, C) ->
  (N, ceil(H/2), ceil(W/2), C), exact in the input dtype (bfloat16 or
  float32), a window with a NaN giving NaN;
- ``max_pool_bwd``: dx from x, its pool y and the cotangent g of y, each
  window's g going to its row-major-first tap equal to y.

On CUDA tensors each wrapper launches the hand-written kernel of
``osvos_torch/csrc/pool.cu`` and counts the launch; on CPU tensors it runs
the plain version (``ops/pool.py``: ``pool_fwd``, ``pool_bwd``). There is no
fallback from one to the other. The counts are per kernel: of the four
pools of an OSVOS forward (or backward), the stage-1 boundary is the one the
JAX package packs (B9, B10) and the three later ones are B7's (B8's).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Wrapper calls that launched the kernel in this process.
fwd_launches = 0   # B7 / B9
bwd_launches = 0   # B8 / B10

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def max_pool_fwd_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``max_pool_fwd``."""
    from osvos_torch.ops.pool import pool_fwd

    return pool_fwd(x)


def max_pool_bwd_ref(x: torch.Tensor, y: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``max_pool_bwd``."""
    from osvos_torch.ops.pool import pool_bwd

    return pool_bwd(x, y, g)


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if (t.device.type != "cuda" or t.dtype != dtype or t.dim() != 4
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous NHWC {dtype} CUDA tensor of "
            f"shape {tuple(shape)}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")


def _pooled_shape(x: torch.Tensor):
    n, h, w, c = x.shape
    return n, -(-h // 2), -(-w // 2), c


def _dtype_code(name: str, x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"{name}: needs a non-empty NHWC bfloat16 or "
                         f"float32 tensor; got {x.dtype} {tuple(x.shape)}")
    _check(name, x, x.shape, x.dtype)
    return _DTYPES[x.dtype]


def max_pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """B7/B9: the (N, ceil(H/2), ceil(W/2), C) pool of NHWC ``x``."""
    global fwd_launches
    if x.device.type == "cpu":
        return max_pool_fwd_ref(x)
    code = _dtype_code("max_pool_fwd", x)
    y = x.new_empty(_pooled_shape(x))
    with torch.cuda.device(x.device):
        err = _entries()[0](x.data_ptr(), y.data_ptr(), *x.shape, code,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_fwd kernel launch failed: CUDA error {err}")
    fwd_launches += 1
    return y


def max_pool_bwd(x: torch.Tensor, y: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """B8/B10: the cotangent of NHWC ``x`` from the cotangent ``g`` of its
    pool ``y``; x, y and g of one dtype."""
    global bwd_launches
    if x.device.type == "cpu":
        return max_pool_bwd_ref(x, y, g)
    code = _dtype_code("max_pool_bwd", x)
    for t in (y, g):
        _check("max_pool_bwd", t, _pooled_shape(x), x.dtype)
        if t.device != x.device:
            raise ValueError("max_pool_bwd: tensors on two devices")
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entries()[1](x.data_ptr(), y.data_ptr(), g.data_ptr(),
                            dx.data_ptr(), *x.shape, code,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


@functools.lru_cache(maxsize=None)
def _entries():
    from osvos_torch.ops.kernels.build import load_library

    lib = load_library("pool")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.osvos_max_pool_fwd
    fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.osvos_max_pool_bwd
    bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    bwd.restype = ctypes.c_int
    return fwd, bwd
