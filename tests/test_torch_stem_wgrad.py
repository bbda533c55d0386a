"""The stem's weight gradient (B16) of the port against the JAX package's.

``stem_wgrad_ref``, the plain version the kernel wrapper takes on the CPU,
is held against the JAX package's tap-stacked stem kernel
(``_stem_wgrad_stacked_impl``, Pallas in interpret mode), reached as the
package reaches it: the vjp of ``flat_conv3x3_input_packed`` with
``_USE_STACKED_STEM_WGRAD`` set, decoded by the package's own
``unpack_dk``. It is also held against the port's general 3x3 weight
gradient plus the column sums of g, at odd H x W.

Both sides sum exact products of bf16 values in float32, in another order:
dK within 1e-5 of max|dK| and db within 1e-5 of the largest column sum of
|g| (float32 rounding of sums over a few hundred pixels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osvos_tpu.ops.pallas import flatconv as fc
from osvos_tpu.ops.pallas.flatconv import FlatGeom
from osvos_torch.ops.kernels import flatconv, stem_wgrad, wgrad

RTOL = 1e-5


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(n, h, w, c, d, seed):
    """An image of the stem's range (the mean-subtracted frame, values up
    to about +-150) and a cotangent, both on the bf16 grid."""
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(n, h, w, c) * 60)
    g = _bf16(rng.randn(n, h, w, d))
    return x, g


def _close(dk, db, want_dk, want_db, g):
    dk, db = np.asarray(dk), np.asarray(db)
    assert dk.shape == want_dk.shape and db.shape == want_db.shape
    assert np.abs(dk - want_dk).max() <= RTOL * np.abs(want_dk).max()
    col = np.abs(g).sum((0, 1, 2)).max()
    assert np.abs(db - want_db).max() <= RTOL * col


def _jax_stacked(x, g, monkeypatch):
    """(dK, db) of the JAX package's stacked stem kernel: the vjp of the
    packed stem conv for cotangent g."""
    n, h, w, c = x.shape
    d = g.shape[-1]
    gp = fc.packed_geom(FlatGeom(n=n, h=h, w=w, c=c, t=8))
    zfp = fc.pack_image(jnp.asarray(x), gp)
    cot = fc.pack_image(jnp.asarray(g),
                        dataclasses.replace(gp, c=2 * fc._half_pad(d)))
    monkeypatch.setattr(fc, "_USE_STACKED_STEM_WGRAD", True)

    def f(k, b):
        z = fc.flat_conv3x3_input_packed(zfp, k, b, gp, True, True)
        return jnp.sum(z.astype(jnp.float32) * cot.astype(jnp.float32))

    k0 = jnp.zeros((3, 3, c, d), jnp.float32)
    b0 = jnp.zeros((d,), jnp.float32)
    dk, db = jax.grad(f, argnums=(0, 1))(k0, b0)
    return np.asarray(dk), np.asarray(db)


@pytest.mark.parametrize("shape", [(2, 12, 20, 3, 16), (1, 9, 14, 3, 8),
                                   (2, 7, 10, 1, 16)])
def test_stem_wgrad_ref_matches_jax_stacked_kernel(shape, monkeypatch):
    x, g = _inputs(*shape, seed=sum(shape))
    want_dk, want_db = _jax_stacked(x, g, monkeypatch)
    dk, db = stem_wgrad.stem_wgrad_ref(torch.from_numpy(x), torch.from_numpy(g))
    assert dk.dtype == db.dtype == torch.float32
    _close(dk, db, want_dk, want_db, g)


@pytest.mark.parametrize("shape", [(2, 17, 29, 3, 8), (1, 5, 3, 2, 12),
                                   (3, 1, 1, 3, 4)])
def test_stem_wgrad_ref_matches_general_wgrad_at_odd_shapes(shape):
    x, g = _inputs(*shape, seed=sum(shape))
    xt, gt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g)
    dk, db = stem_wgrad.stem_wgrad_ref(xt, gt)
    want = wgrad.wgrad3x3_ref(xt, gt).numpy()
    _close(dk, db, want, g.sum((0, 1, 2)), g)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, g = _inputs(2, 9, 13, 3, 8, seed=3)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    before = stem_wgrad.launches
    got = stem_wgrad.stem_wgrad(xt, gt)
    want = stem_wgrad.stem_wgrad_ref(xt, gt)
    assert stem_wgrad.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(flatconv.stem_bwd(xt, gt), want))


def test_plan_covers_every_segment():
    for n, h, w, d in [(5, 480, 854, 64), (2, 17, 29, 8), (1, 1, 1, 64),
                       (2, 480, 854, 64), (5, 480, 854, 130)]:
        per_block, splits = stem_wgrad.plan(n, h, w, d)
        segs = n * h * -(-w // 64)
        assert per_block >= 4 and splits * per_block >= segs
        assert (splits - 1) * per_block < segs
