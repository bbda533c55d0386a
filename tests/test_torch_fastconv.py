"""The port's fast-mode conv and weight gradient against the JAX package's.

``conv3x3_same`` forward, d(input) and d(kernel) against ``jax.vjp`` of
``osvos_tpu.ops.fastconv.conv3x3_same``; the weight gradient's plain version
against the Pallas kernel ``wgrad3x3`` in interpret mode; and the fast-mode
model's trunk gradients, which must be float32 as the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.models import OSVOS as JaxOSVOS
from osvos_tpu.ops import fastconv as jax_fastconv
from osvos_tpu.ops.loss import class_balanced_cross_entropy_loss_per_sample
from osvos_tpu.ops.pallas.wgrad import wgrad3x3 as jax_wgrad3x3
from osvos_torch.configs import ModelConfig
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.ops import loss as port_loss
from osvos_torch.ops.fastconv import conv3x3_same
from osvos_torch.ops.kernels import wgrad

BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values


def _bf16(a):
    """float32 numpy values that bf16 represents exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 9, 13, 8, 4), (1, 17, 22, 3, 16),
                                   (2, 12, 10, 16, 8)])
def test_conv3x3_same_matches_jax_vjp(rng, shape):
    """Forward and d(input) are bf16 convs on both sides: their float32
    accumulations differ in order, so an output may round to the
    neighbouring bf16 value (within 2 ulp of the output's scale). d(kernel)
    is float32 on both sides: within 1e-5 of its scale."""
    n, h, w, c, d = shape
    x = _bf16(rng.randn(n, h, w, c))
    k = rng.randn(3, 3, c, d).astype(np.float32) * 0.3
    g = _bf16(rng.randn(n, h, w, d))
    y, vjp = jax.vjp(jax_fastconv.conv3x3_same,
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(k))
    dx_want, dk_want = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    wt.requires_grad_(True)
    yt = conv3x3_same(xt, wt)
    yt.backward(torch.from_numpy(g).to(torch.bfloat16))

    assert yt.dtype == xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == torch.float32
    for got, want in ((yt.detach(), y), (xt.grad, dx_want)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * BF16_ULP * np.abs(want).max())
    dk = wt.grad.numpy().transpose(2, 3, 1, 0)
    dk_want = np.asarray(dk_want)
    assert dk_want.dtype == np.float32
    np.testing.assert_allclose(dk, dk_want, rtol=0,
                               atol=1e-5 * np.abs(dk_want).max())


@pytest.mark.parametrize("shape", [(2, 9, 13, 8, 4), (1, 33, 49, 64, 64)])
def test_wgrad_plain_matches_pallas_interpret(rng, shape):
    """Both sum exact bf16 products in float32: within 1e-4 of max|dK|."""
    n, h, w, c, d = shape
    x = _bf16(rng.randn(n, h, w, c))
    g = _bf16(rng.randn(n, h, w, d))
    want = np.asarray(jax_wgrad3x3(jnp.asarray(x), jnp.asarray(g),
                                   interpret=True))
    got = wgrad.wgrad3x3(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(g).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (3, 3, c, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_wgrad_plan_covers_every_pixel():
    for shape in [(5, 480, 854, 64, 64), (5, 30, 54, 512, 512),
                  (5, 480, 854, 3, 64), (2, 9, 13, 8, 4), (1, 1, 1, 1, 1)]:
        n, h, w, c, d = shape
        tile_c, splits, chunk = wgrad.plan(*shape)
        pixels = n * h * w
        assert tile_c == (16 if c <= 16 else 64)
        assert chunk % 32 == 0 and splits * chunk >= pixels
        assert (splits - 1) * chunk < pixels


TINY8 = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                            (16, 16, 16)), side_channels=8, compute_mode="fast")


def test_fast_model_trunk_grads_are_float32_and_match_jax(rng):
    """The fine-tune's graph (mode='infer', per-sample CB-BCE) in fast mode:
    every trunk weight gradient is float32 and not bf16-rounded, as the JAX
    package's ``_FastConv`` gives it. Against the JAX package's gradients:
    bf16 activations round at the same places, so the two differ by float32
    sum order (measured: under 1e-6 of each leaf's scale); held at 1e-3,
    which leaves room for an activation next to a bf16 rounding boundary to
    round the other way."""
    x = (rng.randn(2, 33, 49, 3) * 40).astype(np.float32)
    yy, xx = np.mgrid[:33, :49]
    m = np.stack([((yy - 16) ** 2 + (xx - 20 - 5 * i) ** 2 < 120)
                  for i in range(2)]).astype(np.float32)[..., None]
    model = OSVOS(TINY8)
    model.load_state_dict(init_osvos_params(TINY8, torch.Generator().manual_seed(3)))
    params = jax.tree.map(jnp.asarray, params_to_jax(model))

    out = model(torch.from_numpy(x), mode="infer")[-1]
    port_loss.class_balanced_cross_entropy_loss_per_sample(
        out, torch.from_numpy(m)).mean().backward()

    jax_model = JaxOSVOS(JaxModelConfig(**dataclasses.asdict(TINY8)))

    def loss(p):
        o = jax_model.apply({"params": p}, jnp.asarray(x), mode="infer")[-1]
        return class_balanced_cross_entropy_loss_per_sample(
            o, jnp.asarray(m)).mean()

    want = jax.jit(jax.grad(loss))(params)
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith("stage") or not name.endswith("weight"):
            continue
        grad = p.grad
        assert grad.dtype == torch.float32
        assert bool((grad.to(torch.bfloat16).float() != grad).any()), name
        w = np.asarray(want[name.split(".")[0]]["kernel"]).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(grad.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
        checked += 1
    assert checked == 13
