"""Where the fast mode's bias gradients part from the JAX package's.

In fast mode the fine-tune's bias deltas read up to 0.284 of their delta
scale against JAX on the CPU (``tests/test_torch_packed.py``), where every
other leaf reads under 5e-3. One fast train step of the tiny model (the
packed tests' config in fast mode, 2 frames of 32x48) runs here in both
packages from the same weights, frames and output cotangents, with a zero
perturbation on the output of every 3x3 conv (bias added) to read its
cotangent. Both add the bias as ``bias.astype(x.dtype)`` after the bf16
conv (``osvos_tpu/models/vgg_osvos.py:120``; the port's ``_conv3x3``), so
each bias gradient is the sum of a bf16 cotangent over every pixel, rounded
to bf16.

What the step shows, in ulps of bf16 at each tensor's largest magnitude:

- the conv outputs agree within half an ulp and the cotangents within 1.5
  (a value next to a rounding boundary rounds the other way, and a
  cotangent that sums two rounded terms may take both); they are held to
  two ulps;
- the first tensor that parts by more than one ulp, two roundings the
  other way, is a bias gradient, side_prep4's, the first the backward
  computes: 2 ulps, and up to 26 (stage1_conv1's);
- the port's bias gradient is within half an ulp of the exact sum of its
  own cotangent (0.47 at most): it accumulates in float32 and rounds once.
  The JAX one is up to 26 ulps from the exact sum of its own: XLA's CPU
  reduce of a bf16 tensor rounds its partial sums to bf16. The exact sums
  of the two cotangents agree within 2 ulps (1.32 at most).

So the port rounds nowhere that JAX does not; the gap is the JAX package's
CPU reduction, amplified by the cancellation in a sum over every pixel,
and the port is not changed for it (the same reduction of one bf16 tensor
in both packages shows it alone). ``ROADMAP.md`` C records it. The tests
hold the port and its agreement with JAX; how far JAX's reduce parts from
its own exact sum describes the reference, so they print it and do not
hold it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.models import OSVOS as JaxOSVOS
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.parallel import dryrun

FAST = dataclasses.replace(dryrun.TINY, compute_mode="fast")
N, H, W = 2, 32, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps(got, want) -> float:
    """max |got - want| in ulps of bf16 at max |want|."""
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / ulp)


def _port_step(state, x, cots):
    """(conv names in forward order, {name: output}, {name: cotangent},
    {name: bias gradient}) of one port step."""
    model = OSVOS(FAST)
    model.load_state_dict(state)
    conv3x3 = model._conv3x3
    order, outs, perts = [], {}, {}

    def watched(v, name):
        y = conv3x3(v, name)
        perts[name] = torch.zeros_like(y, requires_grad=True)
        order.append(name)
        outs[name] = y + perts[name]
        return outs[name]

    model._conv3x3 = watched
    torch.autograd.backward(model(torch.from_numpy(x)),
                            [torch.from_numpy(c) for c in cots])
    return (order, {k: v.detach().float().numpy() for k, v in outs.items()},
            {k: p.grad.float().numpy() for k, p in perts.items()},
            {k: getattr(model, k).bias.grad.numpy() for k in order})


def _jax_step(state, x, cots, shapes):
    """({name: output}, {name: cotangent}, {name: bias gradient}) of one JAX
    step, the outputs and cotangents read through a zero perturbation that
    an interceptor adds to each 3x3 conv's output."""
    model = JaxOSVOS(JaxModelConfig(**dataclasses.asdict(FAST)))
    tree = jax.tree.map(jnp.asarray, params_to_jax(state))

    def fn(params, perts):
        outs = {}

        def add(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            name = context.module.name
            if context.method_name == "__call__" and name in perts:
                y = y + perts[name]
                outs[name] = y
            return y

        with nn.intercept_methods(add):
            return model.apply({"params": params}, jnp.asarray(x)), outs

    @jax.jit
    def step(params, perts):
        (_, outs), vjp = jax.vjp(fn, params, perts)
        return outs, vjp(([jnp.asarray(c) for c in cots],
                          jax.tree.map(jnp.zeros_like, outs)))

    outs, (g_params, g_perts) = step(
        tree, {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()})
    f32 = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}  # noqa: E731
    return f32(outs), f32(g_perts), {k: np.asarray(v["bias"])
                                     for k, v in g_params.items()}


def test_fast_step_parts_first_at_a_bias_gradient():
    rs = np.random.RandomState(0)
    x = (rs.randn(N, H, W, 3) * 50).astype(np.float32)
    cots = [rs.randn(N, H, W, 1).astype(np.float32) for _ in range(5)]
    state = init_osvos_params(FAST, torch.Generator().manual_seed(11))
    order, outs, cot, bias_grad = _port_step(state, x, cots)
    j_outs, j_cot, j_bias_grad = _jax_step(
        state, x, cots, {k: v.shape for k, v in outs.items()})

    # the step in order: forward outputs, then per conv from the last its
    # cotangent and its bias gradient
    readings = [(f"{k} output", _ulps(outs[k], j_outs[k])) for k in order]
    for k in reversed(order):
        readings += [(f"{k} cotangent", _ulps(cot[k], j_cot[k])),
                     (f"{k}.bias gradient", _ulps(bias_grad[k], j_bias_grad[k]))]
    # the first tensor apart by more than one rounding is a bias gradient
    # (none, should the reference's reduce one day round once)
    first = next((name for name, u in readings if u > 1.0), None)
    print("first apart by more than one bf16 ulp:", first, readings)
    assert first in (None, "side_prep4.bias gradient"), readings
    assert all(u <= 2.0 for name, u in readings
               if not name.endswith("bias gradient")), readings

    # the port rounds the exact sum of its cotangent once, and the exact
    # sums agree; how far JAX's reduce parts from the exact sum of its own
    # is the reference's, printed as the cause and not held
    for k in order:
        exact = cot[k].astype(np.float64).sum(axis=(0, 1, 2))
        j_exact = j_cot[k].astype(np.float64).sum(axis=(0, 1, 2))
        assert _ulps(bias_grad[k], exact) <= 0.5 + 1e-3, k
        assert _ulps(exact, j_exact) <= 2.0, k
    print("JAX's bias gradients from the exact sums of its cotangents, "
          "ulps:", {k: _ulps(j_bias_grad[k], j_cot[k].astype(np.float64)
                              .sum(axis=(0, 1, 2))) for k in order})


def test_one_bf16_bias_reduction_in_both_packages():
    """The bias-add's gradient of one bf16 cotangent, as each model takes
    it: the port's autograd sums in float32 and rounds once, within half an
    ulp of the exact sum; XLA's CPU reduce rounds its partial sums (its
    distance from the exact sum is printed, not held: it is the
    reference's)."""
    rs = np.random.RandomState(1)
    g = torch.from_numpy(rs.randn(N, H, W, 4).astype(np.float32)).bfloat16()
    exact = g.double().sum((0, 1, 2)).numpy()

    bias = torch.zeros(4, requires_grad=True)
    (torch.zeros(g.shape, dtype=torch.bfloat16) + bias.to(torch.bfloat16)
     ).backward(g)
    _, vjp = jax.vjp(lambda b: jnp.zeros(g.shape, jnp.bfloat16)
                     + b.astype(jnp.bfloat16), jnp.zeros(4, jnp.float32))
    j_grad, = vjp(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert _ulps(bias.grad.numpy(), exact) <= 0.5
    print("JAX's reduce, ulps from the exact sum:",
          _ulps(np.asarray(j_grad), exact))
