"""The port's flat-trunk convolutions against the JAX package's.

- The kernels' plain versions (``osvos_torch/ops/kernels/flatconv.py``,
  which the wrappers run on CPU tensors) against the XLA twins that the
  Pallas kernels are tested against: ``flat_conv3x3_ref`` and its
  ``jax.vjp``, ``pool_flat`` and its backward ``_pf_bwd``.
- The autograd ops (``osvos_torch/ops/flatconv.py``) against the Pallas ops
  in interpret mode at one small geometry with an odd width, as
  ``tests/test_flat.py`` runs them. ``side_and_pool_fl`` is held against its
  unfused route (``flatpool._FUSE_POOL_FWD`` off): the fused forward returns
  NaN (ROADMAP.md C1).
- Ties planted in pool windows are routed bit for bit.

The JAX side takes the same bf16 values, laid out in its flat buffers by
``to_flat``; the port's tensors are NHWC.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.ops.pallas import flatpool as jax_flatpool
from osvos_tpu.ops.pallas.flatconv import (FlatGeom, flat_conv3x3,
                                           flat_conv3x3_input,
                                           flat_conv3x3_ref,
                                           flat_side_conv3x3_fl, from_flat,
                                           pool_flat, to_flat)
from osvos_torch.ops import flatconv as port
from osvos_torch.ops.kernels import flatconv as kern
from osvos_torch.ops.pool import pool_bwd, pool_fwd

from tests.test_flat import GEOMS

BF16_STEP = 2.0 ** -7  # the largest relative spacing of bf16 values


def _bf16(a):
    """float32 numpy values that bf16 represents exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a):
    """numpy float32 of bf16 values -> torch bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy()


def _oihw(k):
    """JAX (3, 3, C, D) kernel -> the port's (D, C, 3, 3) weight."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _assert_one_rounding(got, want):
    """bf16 outputs of the same float32 sums taken in another order: within
    one bf16 rounding of the value, plus 2^-16 of the scale for values that
    cancel to near zero."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_array_less(np.abs(got - want),
                                 np.abs(want) * BF16_STEP + scale * 2.0 ** -16
                                 + 1e-30)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * (float(np.abs(want).max()) + 1e-12))


def _inputs(rng, n, h, w, c, d, relu=True, levels=0):
    x = rng.randn(n, h, w, c)
    if levels:  # few distinct values: pool windows tie
        x = np.round(x * levels / 3) * (3 / levels)
    x = _bf16(np.maximum(x, 0) if relu else x)
    k = (rng.randn(3, 3, c, d) * (9 * c) ** -0.5).astype(np.float32)
    b = (rng.randn(d) * 0.1).astype(np.float32)
    return x, k, b


def _geom(x, t=4):
    n, h, w, c = x.shape
    return FlatGeom(n=n, h=h, w=w, c=c, t=t)


# ---------------------------------------------------------------------------
# plain versions against the XLA twins
# ---------------------------------------------------------------------------

SHAPES = [(2, 17, 29, 12, 8), (1, 16, 24, 8, 16), (2, 9, 13, 16, 12)]


@pytest.mark.parametrize("shape", SHAPES + [(2, 17, 29, 3, 8)])
def test_conv_fwd_plain_matches_twin(rng, shape):
    """bias in float32 before the ReLU and the one rounding: within one bf16
    rounding of ``flat_conv3x3_ref`` (relu_output=True)."""
    x, k, b = _inputs(rng, *shape, relu=shape[3] > 3)
    g = _geom(x)
    want = from_flat(flat_conv3x3_ref(to_flat(jnp.asarray(x), g), jnp.asarray(k),
                                      jnp.asarray(b), g, relu_input=False,
                                      relu_output=True),
                     dataclasses.replace(g, c=shape[4]))
    y, pooled = kern.conv_fwd(_t(x), _oihw(k), torch.from_numpy(b))
    assert y.dtype == torch.bfloat16 and pooled is None
    _assert_one_rounding(_np(y), want)
    # the port's twin is the same function
    _assert_one_rounding(_np(port.flat_conv3x3_ref(_t(x), _oihw(k),
                                                   torch.from_numpy(b))), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_bwd_plain_matches_twin_vjp(rng, shape):
    """dz: the twin's input gradient masked by (z > 0), within one rounding.
    dK: float32 here, bf16-rounded by the twin's weight cast, so within
    2^-8 of max|dK|. db: float32 sums in another order, 1e-5 of max|db|.
    B4's wrapper gives B3's dK and db.
    The stem's backward (B16's plain version, one im2col product) gives
    the same dK and db as float32 sums in another order: 1e-5 of the max."""
    n, h, w, c, d = shape
    x, k, b = _inputs(rng, *shape)
    gct = _bf16(rng.randn(n, h, w, d))
    g = _geom(x)
    g_out = dataclasses.replace(g, c=d)

    def twin(zf, kk, bb):
        return flat_conv3x3_ref(zf, kk, bb, g, relu_input=False,
                                relu_output=False)

    zf = to_flat(jnp.asarray(x), g)
    _, vjp = jax.vjp(twin, zf, jnp.asarray(k), jnp.asarray(b))
    dzf, dk_want, db_want = vjp(to_flat(jnp.asarray(gct), g_out))
    dz_want = np.asarray(from_flat(dzf, g), np.float32) * (x > 0)

    dz, dk, db, g_used = kern.conv_bwd(_t(x), _oihw(k), _t(gct))
    assert dz.dtype == torch.bfloat16 and dk.dtype == db.dtype == torch.float32
    assert torch.equal(g_used, _t(gct))
    _assert_one_rounding(_np(dz), dz_want)
    _close(dk.numpy(), dk_want, 2.0 ** -8)
    _close(db.numpy(), db_want, 1e-5)
    dk4, db4 = kern.wgrad_db(_t(x), _t(gct))  # B4, B3's second launch
    assert torch.equal(dk4, dk) and torch.equal(db4, db)
    dk0, db0 = kern.stem_bwd(_t(x), _t(gct))
    _close(dk0.numpy(), dk.numpy(), 1e-5)
    _close(db0.numpy(), db.numpy(), 1e-5)


@pytest.mark.parametrize("geom", GEOMS)
def test_conv_dz_plain_matches_separate_dgrad_pallas(rng, geom):
    """B15, the JAX package's separate flat dgrad
    (``_flat_conv_dgrad_impl``, the dz half of its ``_USE_FUSED_BWD =
    False`` backward) in interpret mode, at ``tests/test_flat.py``'s
    geometries: the port's dz (B3's dz launch, ``conv_bwd``) is the same
    function, conv_T(g, K) * (z > 0) rounded once to bf16, within one bf16
    rounding."""
    from osvos_tpu.ops.pallas.flatconv import _flat_conv_dgrad_impl

    n, h, w, c, d, t = geom
    x, k, _ = _inputs(rng, n, h, w, c, d)
    gct = _bf16(rng.randn(n, h, w, d))
    g = FlatGeom(n=n, h=h, w=w, c=c, t=t)
    dzf = _flat_conv_dgrad_impl(
        to_flat(jnp.asarray(gct), dataclasses.replace(g, c=d)), jnp.asarray(k),
        to_flat(jnp.asarray(x), g), g, d, True)
    want = np.asarray(from_flat(dzf, g), np.float32)
    dz = kern.conv_bwd(_t(x), _oihw(k), _t(gct))[0]
    assert float(np.abs(want).max()) > 0 and (want == 0).any()
    _assert_one_rounding(_np(dz), want)


def _pool_twin(x, r):
    """The JAX pool of NHWC x and, by its vjp, the cotangent it routes from
    the pooled cotangent r (both NHWC)."""
    g = _geom(x)
    n, h, w, c = x.shape
    g2 = FlatGeom(n=n, h=-(-h // 2), w=-(-w // 2), c=c, t=4)
    zf = to_flat(jnp.asarray(x), g)
    pooled, vjp = jax.vjp(lambda z: pool_flat(z, g, g2), zf)
    dzf, = vjp(to_flat(jnp.asarray(r), g2))
    return (np.asarray(from_flat(pooled, g2), np.float32),
            np.asarray(from_flat(dzf, g), np.float32))


@pytest.mark.parametrize("shape", [(2, 17, 29, 8), (1, 16, 24, 16),
                                   (2, 9, 13, 12)])
def test_pool_plain_matches_pool_flat_with_ties(rng, shape):
    """The ceil-mode pool and its routing, bit for bit, on values quantized
    to a few levels so that many windows tie."""
    x = _bf16(np.maximum(np.round(rng.randn(*shape) * 2) / 2, 0))
    pooled = pool_fwd(_t(x))
    r = _bf16(rng.randn(*pooled.shape))
    pooled_want, routed_want = _pool_twin(x, r)
    np.testing.assert_array_equal(_np(pooled), pooled_want)
    np.testing.assert_array_equal(_np(pool_bwd(_t(x), pooled, _t(r))),
                                  routed_want)
    # windows that tie, so the row-major-first rule was exercised
    xp = np.pad(x, ((0, 0), (0, shape[1] % 2), (0, shape[2] % 2), (0, 0)),
                constant_values=-1)
    win = xp.reshape(shape[0], xp.shape[1] // 2, 2, xp.shape[2] // 2, 2, -1)
    ties = int(((win == pooled_want[:, :, None, :, None]).sum((2, 4)) > 1).sum())
    assert ties > 10, ties


@pytest.mark.parametrize("shape", SHAPES)
def test_side_plain_matches_twin(rng, shape):
    """Side forward: the zero-bias twin within one rounding. Side backward
    with the pool's cotangent: the twin's masked dz plus the routed pool
    cotangent, summed in float32 before the one rounding, so within one
    bf16 step of the scale of the bf16-rounded twin terms; dK as in
    test_conv_bwd_plain_matches_twin_vjp."""
    n, h, w, c, d = shape
    x, k, _ = _inputs(rng, *shape, levels=4)
    g = _geom(x)
    zero = jnp.zeros((d,), jnp.float32)
    zf = to_flat(jnp.asarray(x), g)
    side_want = from_flat(flat_conv3x3_ref(zf, jnp.asarray(k), zero, g,
                                           relu_input=False),
                          dataclasses.replace(g, c=d))
    side, pooled = kern.side_fwd(_t(x), _oihw(k), pool=True)
    _assert_one_rounding(_np(side), side_want)

    gct = _bf16(rng.randn(n, h, w, d))
    r = _bf16(rng.randn(*pooled.shape))
    pooled_want, routed_want = _pool_twin(x, r)
    np.testing.assert_array_equal(_np(pooled), pooled_want)
    _, vjp = jax.vjp(lambda z, kk: flat_conv3x3_ref(z, kk, zero, g,
                                                    relu_input=False),
                     zf, jnp.asarray(k))
    dzf, dk_want = vjp(to_flat(jnp.asarray(gct), dataclasses.replace(g, c=d)))
    dz_want = (np.asarray(from_flat(dzf, g), np.float32) * (x > 0)
               + routed_want)
    dz, dk = kern.side_bwd(_t(x), _oihw(k), _t(gct), pool=(pooled, _t(r)))
    _close(_np(dz), dz_want, BF16_STEP)
    _close(dk.numpy(), dk_want, 2.0 ** -8)


# ---------------------------------------------------------------------------
# the autograd ops against the Pallas ops in interpret mode
# ---------------------------------------------------------------------------

N, H, W, C, D, SIDE_D = 2, 10, 13, 8, 8, 8


def _op_inputs(rng, c=C, relu=True):
    x, k, b = _inputs(rng, N, H, W, c, D, relu=relu)
    return x, k, b, _geom(x)


def _port_grads(fn, x, k, b, r, x_grad=True):
    """Values and (dx, dK, db) of sum(fn(x, k, b) * r) through the port."""
    xt = _t(x).requires_grad_(x_grad)
    kt = _oihw(k).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True) if b is not None else None
    out = fn(xt, kt, bt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    dk = kt.grad.numpy().transpose(2, 3, 1, 0)
    return (_np(out), _np(xt.grad) if x_grad else None, dk,
            None if bt is None else bt.grad.numpy())


def test_flat_conv3x3_matches_pallas_interpret(rng):
    """Values within one rounding; dz within one rounding of the Pallas
    kernel's (its masked, bf16-rounded input gradient); dK and db within
    1e-4 of their scale (float32 sums of the same bf16 products)."""
    x, k, b, g = _op_inputs(rng)
    g_out = dataclasses.replace(g, c=D)
    r = rng.randn(N, H, W, D).astype(np.float32)

    def loss(zf, kk, bb):
        y = flat_conv3x3(zf, kk, bb, g, False, True, True)
        return jnp.sum(from_flat(y, g_out).astype(jnp.float32) * r)

    zf = to_flat(jnp.asarray(x), g)
    y_want = from_flat(flat_conv3x3(zf, jnp.asarray(k), jnp.asarray(b), g,
                                    False, True, True), g_out)
    dzf, dk_want, db_want = jax.grad(loss, argnums=(0, 1, 2))(
        zf, jnp.asarray(k), jnp.asarray(b))
    y, dz, dk, db = _port_grads(port.flat_conv3x3, x, k, b, r)
    _assert_one_rounding(y, y_want)
    _assert_one_rounding(dz, from_flat(dzf, g))
    _close(dk, dk_want, 1e-4)
    _close(db, db_want, 1e-4)


def test_flat_conv3x3_input_matches_pallas_interpret(rng):
    """The stem: values within one rounding, dK and db within 1e-4 of
    their scale, and no gradient for the image."""
    x, k, b, g = _op_inputs(rng, c=3, relu=False)
    g_out = dataclasses.replace(g, c=D)
    r = rng.randn(N, H, W, D).astype(np.float32)

    def loss(kk, bb):
        y = flat_conv3x3_input(zf, kk, bb, g, True, True)
        return jnp.sum(from_flat(y, g_out).astype(jnp.float32) * r)

    zf = to_flat(jnp.asarray(x), g)
    y_want = from_flat(flat_conv3x3_input(zf, jnp.asarray(k), jnp.asarray(b),
                                          g, True, True), g_out)
    dk_want, db_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k),
                                                      jnp.asarray(b))
    y, _, dk, db = _port_grads(port.flat_conv3x3_input, x, k, b, r,
                               x_grad=False)
    _assert_one_rounding(y, y_want)
    _close(dk, dk_want, 1e-4)
    _close(db, db_want, 1e-4)


def _side_weights(rng, c=C):
    return (rng.randn(3, 3, c, SIDE_D) * 0.1).astype(np.float32)


def test_flat_side_conv3x3_fl_matches_pallas_interpret(rng):
    """The TPU side kernel rounds each tap's projection to bf16 before it
    sums the nine (``tests/test_flat.py``), the port rounds once: values,
    dz and dK within 3e-2 of their scale, the bound of test_flat.py."""
    x, _, _, g = _op_inputs(rng)
    k = _side_weights(rng)
    r = rng.randn(N, H, W, SIDE_D).astype(np.float32)
    g_side = dataclasses.replace(g, c=SIDE_D)

    def loss(zf, kk):
        sf = flat_side_conv3x3_fl(zf, kk, g, True)
        return jnp.sum(from_flat(sf, g_side).astype(jnp.float32) * r)

    zf = to_flat(jnp.asarray(x), g)
    side_want = from_flat(flat_side_conv3x3_fl(zf, jnp.asarray(k), g, True),
                          g_side)
    dzf, dk_want = jax.grad(loss, argnums=(0, 1))(zf, jnp.asarray(k))
    side, dz, dk, _ = _port_grads(
        lambda xt, kt, _: port.flat_side_conv3x3_fl(xt, kt), x, k, None, r)
    _close(side, side_want, 3e-2)
    _close(dz, from_flat(dzf, g), 3e-2)
    _close(dk, dk_want, 3e-2)


def test_side_and_pool_fl_matches_pallas_unfused(rng, monkeypatch):
    """The pooled map bit for bit; the side values, dz and dK within 3e-2
    of their scale (as test_flat_side_conv3x3_fl_matches_pallas_interpret);
    ties planted in the input's windows."""
    monkeypatch.setattr(jax_flatpool, "_FUSE_POOL_FWD", False)
    x, _, _ = _inputs(rng, N, H, W, C, D, levels=4)
    g = _geom(x)
    k = _side_weights(rng)
    g2 = FlatGeom(n=N, h=-(-H // 2), w=-(-W // 2), c=C, t=4)
    g_side = dataclasses.replace(g, c=SIDE_D)
    r1 = rng.randn(N, H, W, SIDE_D).astype(np.float32)
    r2 = rng.randn(N, g2.h, g2.w, C).astype(np.float32)

    def loss(zf, kk):
        sf, pf = jax_flatpool.side_and_pool_fl(zf, kk, g, g2, True)
        return (jnp.sum(from_flat(sf, g_side).astype(jnp.float32) * r1)
                + jnp.sum(from_flat(pf, g2).astype(jnp.float32) * r2))

    zf = to_flat(jnp.asarray(x), g)
    sf, pf = jax_flatpool.side_and_pool_fl(zf, jnp.asarray(k), g, g2, True)
    dzf, dk_want = jax.grad(loss, argnums=(0, 1))(zf, jnp.asarray(k))

    xt = _t(x).requires_grad_(True)
    kt = _oihw(k).requires_grad_(True)
    side, pooled = port.side_and_pool_fl(xt, kt)
    ((side.float() * torch.from_numpy(r1)).sum()
     + (pooled.float() * torch.from_numpy(r2)).sum()).backward()
    np.testing.assert_array_equal(_np(pooled),
                                  np.asarray(from_flat(pf, g2), np.float32))
    _close(_np(side), from_flat(sf, g_side), 3e-2)
    _close(_np(xt.grad), from_flat(dzf, g), 3e-2)
    _close(kt.grad.numpy().transpose(2, 3, 1, 0), dk_want, 3e-2)


@pytest.mark.parametrize("shape", [(2, 17, 29, 12, 8), (1, 16, 24, 8, 16)])
def test_conv_pool_matches_twin_with_ties(rng, shape):
    """conv_pool against the twins flat_conv3x3_ref + pool_flat: pooled
    values within one rounding; with the same conv output, the routed
    cotangent bit for bit, and dz, dK, db as the plain conv backward."""
    n, h, w, c, d = shape
    x, k, b = _inputs(rng, *shape)
    b = np.round(b * 4) / 4  # coarse biases: more exact ties after ReLU
    g = _geom(x)
    zf = to_flat(jnp.asarray(x), g)
    y_want = np.asarray(from_flat(
        flat_conv3x3_ref(zf, jnp.asarray(k), jnp.asarray(b), g,
                         relu_input=False, relu_output=True),
        dataclasses.replace(g, c=d)), np.float32)
    xt = _t(x).requires_grad_(True)
    kt, bt = _oihw(k).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    pooled = port.conv_pool(xt, kt, bt)
    y, _ = kern.conv_fwd(_t(x), _oihw(k), torch.from_numpy(b))
    pooled_want, _ = _pool_twin(y_want, np.zeros(pooled.shape, np.float32))
    _assert_one_rounding(_np(pooled), pooled_want)

    r = _bf16(rng.randn(*pooled.shape))
    (pooled.float() * torch.from_numpy(r)).sum().backward()
    _, routed_want = _pool_twin(_np(y), r)
    assert int((routed_want != 0).sum()) > 0
    dz, dk, db, routed = kern.conv_bwd(_t(x), _oihw(k),
                                       route=(y, pool_fwd(y), _t(r)))
    np.testing.assert_array_equal(_np(routed), routed_want)
    assert torch.equal(xt.grad, dz)
    assert torch.equal(kt.grad, dk.permute(3, 2, 0, 1))
    assert torch.equal(bt.grad, db)
    dz_plain, dk_plain, db_plain, _ = kern.conv_bwd(_t(x), _oihw(k), routed)
    assert torch.equal(dz, dz_plain) and torch.equal(dk, dk_plain)
    assert torch.equal(db, db_plain)
