"""The port's class-balanced BCE against the JAX package's, on the same
numpy inputs: values and gradients, both routes on each side.

On the CPU the JAX package's impl='pallas' runs its Pallas kernels in
interpret mode, and the port's impl='pallas' runs its CUDA kernels' plain
versions through the same autograd.Function as on the card. Tolerance:
rtol 1e-5 on losses (float32 sums in another order over up to 25k
elements); gradients within 1e-5 of their largest entry (sigmoid(x) - 1
against the log-sigmoid derivative: the same value to float32 round-off).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.ops import loss as jax_loss
from osvos_torch.ops import loss as port_loss

SHAPES = [(1, 65, 97, 1), (2, 33, 49, 1), (1, 700), (3, 5, 7, 1)]
IMPLS = ["xla", "pallas"]


def _inputs(rng, shape, scale=5.0):
    x = (rng.randn(*shape) * scale).astype(np.float32)
    z = (rng.rand(*shape) > 0.7).astype(np.float32)
    return x, z


def _close_grads(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_impl", IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size_average,batch_average",
                         [(False, True), (False, False), (True, False)])
def test_whole_batch_loss_matches_jax(rng, shape, jax_impl, impl, size_average,
                                      batch_average):
    x, z = _inputs(rng, shape)

    def jax_fn(v):
        return jax_loss.class_balanced_cross_entropy_loss(
            v, jnp.asarray(z), size_average, batch_average, impl=jax_impl)

    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_loss.class_balanced_cross_entropy_loss(
        xt, torch.from_numpy(z), size_average, batch_average, impl=impl)
    got.backward()
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grads(xt.grad.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("shape", [s for s in SHAPES if len(s) == 4])
@pytest.mark.parametrize("jax_impl", IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_per_sample_loss_matches_jax(rng, shape, jax_impl, impl):
    """Values and the gradient of a weighted sum, so that the per-sample
    cotangents differ."""
    x, z = _inputs(rng, shape)
    w = (rng.rand(shape[0]) + 0.5).astype(np.float32)

    def jax_fn(v):
        per = jax_loss.class_balanced_cross_entropy_loss_per_sample(
            v, jnp.asarray(z), impl=jax_impl)
        return (per * w).sum(), per

    (_, want), want_g = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_loss.class_balanced_cross_entropy_loss_per_sample(
        xt, torch.from_numpy(z), impl=impl)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    _close_grads(xt.grad.numpy(), np.asarray(want_g))


def test_per_sample_rows_equal_whole_batch_of_one(rng):
    x, z = _inputs(rng, (3, 11, 13, 1))
    per = port_loss.class_balanced_cross_entropy_loss_per_sample(
        torch.from_numpy(x), torch.from_numpy(z), impl="pallas")
    for b in range(3):
        one = port_loss.class_balanced_cross_entropy_loss(
            torch.from_numpy(x[b:b + 1]), torch.from_numpy(z[b:b + 1]))
        np.testing.assert_allclose(float(per[b]), float(one), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 65, 97, 1), (2, 33, 49, 1)])
def test_theoretical_loss_matches_jax(rng, shape):
    x, z = _inputs(rng, shape, scale=2.0)
    want = jax_loss.class_balanced_cross_entropy_loss_theoretical(
        jnp.asarray(x), jnp.asarray(z))
    got = port_loss.class_balanced_cross_entropy_loss_theoretical(
        torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    stable = port_loss.class_balanced_cross_entropy_loss(
        torch.from_numpy(x), torch.from_numpy(z), batch_average=False)
    np.testing.assert_allclose(float(got), float(stable), rtol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_extreme_logits_stay_finite(impl):
    x = np.array([[-200.0, 200.0, 0.0, -5.0, 100.0, -100.0, 100.0, -100.0]],
                 np.float32)
    z = np.array([[0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    want, want_g = jax.value_and_grad(
        lambda v: jax_loss.class_balanced_cross_entropy_loss(
            v, jnp.asarray(z), impl="pallas"))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port_loss.class_balanced_cross_entropy_loss(xt, torch.from_numpy(z),
                                                      impl=impl)
    got.backward()
    assert np.isfinite(float(got.detach())) and bool(torch.isfinite(xt.grad).all())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grads(xt.grad.numpy(), np.asarray(want_g))


def test_bf16_logits_are_reduced_in_float32(rng):
    x, z = _inputs(rng, (2, 33, 49, 1))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for impl in IMPLS:
        got = port_loss.class_balanced_cross_entropy_loss_per_sample(
            xb, torch.from_numpy(z), impl=impl)
        want = port_loss.class_balanced_cross_entropy_loss_per_sample(
            xb.float(), torch.from_numpy(z), impl=impl)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        port_loss.class_balanced_cross_entropy_loss(torch.zeros(1, 4),
                                                    torch.zeros(1, 4), impl="x")
