"""The port's stage-boundary max pool against the JAX package's pools.

``ops/pool.max_pool_ceil`` on CPU tensors runs the plain versions of the
CUDA kernels B7-B10 (``ops/kernels/pool.py``). Its forward and its
autograd backward are held, bit for bit, on bf16 values quantized to a few
levels so that windows tie often, against:

- ``pool_flat_p`` (B7 forward, B8 backward) in Pallas interpret mode, at
  ``tests/test_flat.py``'s ``POOL_GEOMS``, through ``to_flat``/``from_flat``;
- ``pool_packed_p`` (B9, B10) in interpret mode at ``PP_GEOMS``, through
  ``pack_image``/``unpack_image``;
- ``osvos_tpu.ops.pool.max_pool_ceil`` and its VJP, in float32 and bf16.

B7-B10 pool the trunk's post-ReLU activations, and they are held on such
values (zeros tie often). On signed values B8 differs from its twin and
from the port at one kind of ragged window (ROADMAP.md C):
``test_b8_routes_to_the_pad_where_a_ragged_window_peaks_at_zero``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.ops import pool as jax_pool
from osvos_tpu.ops.pallas.flatconv import (FlatGeom, from_flat, pack_image,
                                           packed_geom, stage_t, to_flat,
                                           unpack_image)
from osvos_tpu.ops.pallas.flatpool import pool_flat_p, pool_packed_p
from osvos_torch.ops import pool as port_pool
from osvos_torch.ops.kernels import pool as kpool

from tests.test_flat import POOL_GEOMS, PP_GEOMS

BF16 = torch.bfloat16


def _tied(rng, shape, levels=4, relu=False):
    """bf16-exact float32 values on a few levels: many windows tie;
    ``relu`` keeps the positive part, a post-ReLU activation."""
    x = np.round(rng.randn(*shape) * levels / 3) * (3 / levels)
    x = np.maximum(x, 0) if relu else x
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _port(x, r, dtype=BF16):
    """The port's pool of NHWC ``x`` and the cotangent its backward routes
    from the pooled cotangent ``r``, as float32 numpy."""
    xt = torch.tensor(x).to(dtype).requires_grad_()
    y = port_pool.max_pool_ceil(xt)
    (y.float() * torch.from_numpy(r)).sum().backward()
    return y.float().detach().numpy(), xt.grad.float().numpy()


def _count_ties(x, y):
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)),
                constant_values=-np.inf)
    win = xp.reshape(n, (h + 1) // 2, 2, (w + 1) // 2, 2, c)
    return int(((win == y[:, :, None, :, None]).sum((2, 4)) > 1).sum())


@pytest.mark.parametrize("gt", POOL_GEOMS)
def test_pool_matches_pool_flat_pallas(rng, gt):
    """B7/B8: values and routed cotangent bit for bit."""
    n, h1, w1, c, ti, to = gt
    g_in = FlatGeom(n=n, h=h1, w=w1, c=c, t=ti)
    g_out = FlatGeom(n=n, h=-(-h1 // 2), w=-(-w1 // 2), c=c, t=to)
    x = _tied(rng, (n, h1, w1, c), relu=True)
    r = _tied(rng, (n, g_out.h, g_out.w, c), levels=64)
    zf = to_flat(jnp.asarray(x), g_in)
    out, vjp = jax.vjp(lambda z: pool_flat_p(z, g_in, g_out, True), zf)
    (dz,) = vjp(to_flat(jnp.asarray(r), g_out))
    y, dx = _port(x, r)
    np.testing.assert_array_equal(y, np.asarray(from_flat(out, g_out), np.float32))
    np.testing.assert_array_equal(dx, np.asarray(from_flat(dz, g_in), np.float32))
    assert _count_ties(x, y) > 0


@pytest.mark.parametrize("gt", PP_GEOMS)
def test_pool_matches_pool_packed_pallas(rng, gt):
    """B9/B10, from the pixel-pair-packed stage-1 buffer: bit for bit."""
    n, h1, w1, c, to = gt
    g = FlatGeom(n=n, h=h1, w=w1, c=c, t=stage_t(-(-h1 // 2)))
    gp = packed_geom(g)
    g_out = FlatGeom(n=n, h=h1 // 2, w=w1 // 2, c=c, t=to)
    x = _tied(rng, (n, h1, w1, c), relu=True)
    r = _tied(rng, (n, g_out.h, g_out.w, c), levels=64)
    zfp = pack_image(jnp.asarray(x), gp)
    out, vjp = jax.vjp(lambda z: pool_packed_p(z, gp, g_out, True), zfp)
    (dz,) = vjp(to_flat(jnp.asarray(r), g_out))
    y, dx = _port(x, r)
    np.testing.assert_array_equal(y, np.asarray(from_flat(out, g_out), np.float32))
    np.testing.assert_array_equal(
        dx, np.asarray(unpack_image(dz, gp, c), np.float32))
    assert _count_ties(x, y) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 29, 12), (1, 1, 1, 3),
                                   (3, 8, 5, 64), (1, 60, 107, 8)])
def test_pool_matches_jax_max_pool_ceil(rng, shape, dtype):
    """Against the JAX trunk's pool and its VJP (the fast and parity
    models' pool), bit for bit."""
    x = _tied(rng, shape)
    n, h, w, c = shape
    r = _tied(rng, (n, -(-h // 2), -(-w // 2), c), levels=64)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(jax_pool.max_pool_ceil, jnp.asarray(x, jdt))
    (dx_want,) = vjp(jnp.asarray(r, jdt))
    y, dx = _port(x, r, getattr(torch, dtype))
    np.testing.assert_array_equal(y, np.asarray(out, np.float32))
    np.testing.assert_array_equal(dx, np.asarray(dx_want, np.float32))


def test_b8_routes_to_the_pad_where_a_ragged_window_peaks_at_zero():
    """A reference fault off B8's domain: in a ragged last column whose
    top tap is negative and bottom tap is zero, B8 compares the off-image
    pad (a zero in the flat buffer) with the max 0 before the bottom tap
    and routes the cotangent to the pad, which is dropped. Its twin
    ``pool_flat``, ``max_pool_ceil`` and the port route it to the bottom
    tap. Post-ReLU inputs have no negative tap, so the trunk never meets
    this window."""
    from osvos_tpu.ops.pallas.flatconv import pool_flat

    g_in = FlatGeom(n=1, h=2, w=3, c=1, t=4)
    g_out = FlatGeom(n=1, h=1, w=2, c=1, t=4)
    x = np.array([[1.0, 2.0, -1.0], [0.5, 0.25, 0.0]],
                 np.float32).reshape(1, 2, 3, 1)
    r = np.array([3.0, 5.0], np.float32).reshape(1, 1, 2, 1)
    _, dx = _port(x, r)
    assert dx[0, :, 2, 0].tolist() == [0.0, 5.0]
    zf = to_flat(jnp.asarray(x), g_in)
    rf = to_flat(jnp.asarray(r), g_out)
    routed = {}
    for name, fn in (("B8", lambda z: pool_flat_p(z, g_in, g_out, True)),
                     ("twin", lambda z: pool_flat(z, g_in, g_out))):
        _, vjp = jax.vjp(fn, zf)
        routed[name] = np.asarray(from_flat(vjp(rf)[0], g_in), np.float32)
    np.testing.assert_array_equal(routed["twin"], dx)
    assert routed["B8"][0, :, 2, 0].tolist() == [0.0, 0.0]


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu(rng):
    """On CPU tensors the wrappers are their plain versions and count no
    launch; anything but a CPU or CUDA tensor is refused."""
    x = torch.from_numpy(_tied(rng, (2, 9, 7, 8))).to(BF16)
    before = (kpool.fwd_launches, kpool.bwd_launches)
    y = kpool.max_pool_fwd(x)
    assert torch.equal(y, port_pool.pool_fwd(x))
    g = torch.ones_like(y)
    assert torch.equal(kpool.max_pool_bwd(x, y, g), port_pool.pool_bwd(x, y, g))
    assert (kpool.fwd_launches, kpool.bwd_launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        kpool.max_pool_fwd(x.to("meta"))
