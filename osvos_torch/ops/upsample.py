"""Fixed bilinear upsampling with transposed-convolution semantics.

The reference upsamples side outputs with ``ConvTranspose2d(C, C,
k=2*factor, stride=factor, bias=False)`` whose weights are a bilinear kernel
on the channel diagonal, frozen at lr=0. Here the kernel is a constant and
the op is either a depthwise ``conv_transpose2d`` (``method='conv'``, parity
mode) or two contractions with 1-D interpolation matrices
(``method='matmul'``, fast mode): the 2-D kernel is an outer product of 1-D
tents, so the map separates. Counterpart of ``osvos_tpu/ops/upsample.py``;
the numpy helpers are restated here so the port does not import jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_filter(size: int) -> np.ndarray:
    """The (size, size) bilinear kernel of the reference's ``upsample_filt``:
    a separable tent centred at ``factor - 1`` (odd size) or
    ``factor - 0.5`` (even size)."""
    factor = (size + 1) // 2
    center = factor - 1.0 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    filt = (1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)
    return filt.astype(np.float32)


def interp_surgery_weights(channels: int, size: int) -> np.ndarray:
    """The reference's ``interp_surgery`` OIHW (C, C, k, k) ConvTranspose2d
    weight: the bilinear kernel on the channel diagonal, zero elsewhere."""
    filt = bilinear_filter(size)
    w = np.zeros((channels, channels, size, size), np.float32)
    for c in range(channels):
        w[c, c] = filt
    return w


def _bilinear_filter_1d(size: int) -> np.ndarray:
    factor = (size + 1) // 2
    center = factor - 1.0 if size % 2 == 1 else factor - 0.5
    og = np.arange(size, dtype=np.float64)
    return (1 - np.abs(og - center) / factor).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, factor: int) -> np.ndarray:
    """(n_out, n_in) matrix of the 1-D transposed bilinear conv,
    n_out = (n_in - 1) * factor + 2 * factor. Cached and shared: callers
    must not write to it."""
    k = 2 * factor
    n_out = (n_in - 1) * factor + k
    k1d = _bilinear_filter_1d(k)
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_in):
        lo = i * factor  # output offset of tap 0 for source i
        m[lo:lo + k, i] += k1d
    return m


def bilinear_upsample(x: torch.Tensor, factor: int,
                      method: str = "conv") -> torch.Tensor:
    """Upsample NHWC ``x`` by ``factor`` as the reference's frozen
    ``ConvTranspose2d(C, C, 2*factor, stride=factor)`` does. Output spatial
    size: (dim - 1) * factor + 2 * factor.

    method='conv': depthwise transposed conv (``groups=C``).
    method='matmul': the same linear map as two dense contractions with the
    per-axis interpolation matrices; equal up to f32 reassociation.
    """
    if factor == 1:
        return x
    if method == "matmul":
        uh = torch.from_numpy(_interp_matrix(x.shape[1], factor)).to(x)
        uw = torch.from_numpy(_interp_matrix(x.shape[2], factor)).to(x)
        y = torch.einsum("ph,nhwc->npwc", uh, x)
        return torch.einsum("qw,npwc->npqc", uw, y)
    if method != "conv":
        raise ValueError(f"unknown upsample method {method!r}")
    k = 2 * factor
    c = x.shape[-1]
    # conv_transpose2d weight: (in, out / groups, k, k); the tent is
    # symmetric, so no spatial flip is needed.
    w = torch.from_numpy(bilinear_filter(k)).to(x).expand(c, 1, k, k)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.contiguous(),
                           stride=factor, groups=c)
    return y.permute(0, 2, 3, 1)
