"""The port's device-side ScaleNRotate against the JAX package's
``osvos_tpu.ops.warp`` on the same numpy inputs.

Tolerances: nearest resampling picks the same pixel, so it is exact; cubic
and linear sum the same taps with the same weights in float32 in another
order, so they agree within 1e-4 of the image's scale. The affine matrix
goes through float32 cos/sin on both sides: within 1e-6 of its entries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.ops import warp as jax_warp
from osvos_torch.ops import warp


def _image(rng, h=33, w=49, c=3):
    return (rng.randn(h, w, c) * 40).astype(np.float32)


def _mask(h=33, w=49):
    yy, xx = np.mgrid[:h, :w]
    return (((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (h / 3) ** 2
            ).astype(np.float32)[..., None]


@pytest.mark.parametrize("angle,scale", [(17.5, 0.8), (-29.0, 1.2), (0.0, 1.0),
                                         (90.0, 1.0)])
def test_rotation_scale_matrix_matches_jax(angle, scale):
    want = np.asarray(jax_warp.rotation_scale_matrix(
        jnp.float32(angle), jnp.float32(scale), (24.5, 16.5)))
    got = warp.rotation_scale_matrix(torch.tensor(angle), torch.tensor(scale),
                                     (24.5, 16.5))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("interp", ["cubic", "linear", "nearest"])
@pytest.mark.parametrize("angle,scale", [(17.5, 0.8), (-29.0, 1.2)])
def test_warp_affine_matches_jax(rng, interp, angle, scale):
    img = _image(rng) if interp != "nearest" else _mask()
    m = np.array(jax_warp.rotation_scale_matrix(
        jnp.float32(angle), jnp.float32(scale), (24.5, 16.5)))
    want = np.asarray(jax_warp.warp_affine(jnp.asarray(img), jnp.asarray(m),
                                           interp=interp))
    got = warp.warp_affine(torch.from_numpy(img), torch.from_numpy(m),
                           interp).numpy()
    assert got.shape == img.shape and got.dtype == np.float32
    if interp == "nearest":
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size  # the blob survives, not all of it
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(img).max())


def test_warp_affine_rejects_unknown_interp():
    with pytest.raises(ValueError):
        warp.warp_affine(torch.zeros(4, 4, 1), torch.eye(2, 3), "area")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_n_rotate_with_replayed_draws_matches_jax(rng, seed):
    """The JAX package's draws (flip, angle, scale from one key, as its
    ``scale_n_rotate`` makes them) applied by the port give its output."""
    img, mask = _image(rng), _mask()
    key = jax.random.PRNGKey(seed)
    want_img, want_mask = jax_warp.scale_n_rotate(key, jnp.asarray(img),
                                                  jnp.asarray(mask))
    kf, kr, ks = jax.random.split(key, 3)
    flip = bool(jax.random.uniform(kf) < 0.5)
    angle = float(jax.random.uniform(kr, minval=-30.0, maxval=30.0))
    scale = float(jax.random.uniform(ks, minval=0.75, maxval=1.25))
    got_img, got_mask = warp.apply_scale_n_rotate(
        torch.from_numpy(img), torch.from_numpy(mask), torch.tensor(flip),
        torch.tensor(angle, dtype=torch.float32),
        torch.tensor(scale, dtype=torch.float32))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0,
                               atol=1e-4 * np.abs(img).max())


def test_draws_follow_the_configured_ranges():
    gen = torch.Generator().manual_seed(0)
    flip, angle, scale = warp.draw_scale_n_rotate(4000, (-30.0, 30.0),
                                                  (0.75, 1.25), 0.5, gen)
    assert flip.dtype == torch.bool and 0.45 < float(flip.float().mean()) < 0.55
    assert float(angle.min()) >= -30.0 and float(angle.max()) <= 30.0
    assert float(scale.min()) >= 0.75 and float(scale.max()) <= 1.25
    again = warp.draw_scale_n_rotate(4000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[1], angle)
    img, mask = warp.scale_n_rotate(torch.from_numpy(_image(np.random.RandomState(0))),
                                    torch.from_numpy(_mask()),
                                    generator=torch.Generator().manual_seed(1))
    assert img.shape == (33, 49, 3) and mask.shape == (33, 49, 1)
    assert set(np.unique(mask.numpy())) <= {0.0, 1.0}
