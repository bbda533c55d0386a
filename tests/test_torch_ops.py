"""The port's ops against the JAX package's, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osvos_tpu.ops import crop as jax_crop
from osvos_tpu.ops import pool as jax_pool
from osvos_tpu.ops import upsample as jax_up
from osvos_tpu.ops.pallas import fused_head as jax_fused_head
from osvos_torch.ops import crop, pool, upsample
from osvos_torch.ops.kernels import fused_head


@pytest.mark.parametrize("shape,target", [((2, 70, 101, 3), (65, 97)),
                                          ((1, 64, 96, 2), (64, 96)),
                                          ((1, 9, 8, 1), (4, 7))])
def test_center_crop_matches_jax(rng, shape, target):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jax_crop.center_crop(jnp.asarray(x), *target))
    got = crop.center_crop(torch.from_numpy(x), *target).numpy()
    np.testing.assert_array_equal(got, want)


def test_center_crop_rejects_smaller_input():
    with pytest.raises(ValueError):
        crop.center_crop(torch.zeros(1, 4, 4, 1), 5, 4)


@pytest.mark.parametrize("hw", [(65, 97), (7, 9), (64, 96), (1, 3)])
def test_max_pool_ceil_matches_jax(rng, hw):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_pool.max_pool_ceil(jnp.asarray(x)))
    got = pool.max_pool_ceil(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_max_pool_ceil_davis_chain():
    """854 -> 427 -> 214 -> 107 -> 54 and 480 -> 240 -> 120 -> 60 -> 30,
    the trailing padding rule of osvos_tpu/ops/pool.py:_ceil_pad."""
    x = torch.zeros(1, 480, 854, 1, dtype=torch.bfloat16)
    sizes = []
    for _ in range(4):
        x = pool.max_pool_ceil(x)
        sizes.append(tuple(x.shape[1:3]))
    assert sizes == [(240, 427), (120, 214), (60, 107), (30, 54)]
    for n in (854, 427, 214, 107, 480, 240, 120, 60):
        assert -(-n // 2) == (n + jax_pool._ceil_pad(n, 2, 2)) // 2


@pytest.mark.parametrize("size", [3, 4, 8, 16, 32])
def test_bilinear_filters_equal_jax(size):
    np.testing.assert_array_equal(upsample.bilinear_filter(size),
                                  jax_up.bilinear_filter(size))
    np.testing.assert_array_equal(upsample.interp_surgery_weights(3, size),
                                  jax_up.interp_surgery_weights(3, size))


@pytest.mark.parametrize("n_in,factor", [(240, 2), (120, 4), (60, 8), (30, 16),
                                         (427, 2), (214, 4), (107, 8), (54, 16),
                                         (5, 2)])
def test_interp_matrices_equal_jax(n_in, factor):
    np.testing.assert_array_equal(upsample._interp_matrix(n_in, factor),
                                  jax_up._interp_matrix(n_in, factor))
    n_out = n_in * factor - 3  # any crop the reference can ask for
    np.testing.assert_array_equal(
        fused_head._cropped_interp(n_in, factor, n_out),
        jax_fused_head._cropped_interp(n_in, factor, n_out))


@pytest.mark.parametrize("method", ["conv", "matmul"])
@pytest.mark.parametrize("factor", [2, 4, 8, 16])
def test_bilinear_upsample_matches_jax(rng, method, factor):
    """f32 on both sides: agreement to f32 reassociation (1e-5 of scale)."""
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax_up.bilinear_upsample(jnp.asarray(x), factor,
                                               method=method))
    got = upsample.bilinear_upsample(torch.from_numpy(x), factor,
                                     method=method).numpy()
    assert got.shape == want.shape == (2, 6 * factor, 8 * factor, 3)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_bilinear_upsample_forms_agree(rng):
    x = torch.from_numpy(rng.randn(1, 6, 9, 4).astype(np.float32))
    a = upsample.bilinear_upsample(x, 8, method="conv")
    b = upsample.bilinear_upsample(x, 8, method="matmul")
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(a.abs().max()))
