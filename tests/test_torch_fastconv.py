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


def _assert_covers_every_pixel(p, shape):
    """The Hopper plan's block runs partition the tile-major K-steps, each
    tile's K-steps cover its N * H rows of W pixels once, and the pieces
    the second pass adds for a tile are exactly the blocks whose runs meet
    it, with distinct piece ids; the wmma plan's chunks cover the pixels
    once."""
    n, h, w, c, d = shape
    if p.path == "wmma":
        pixels = n * h * w
        assert p.chunk % 32 == 0 and p.blocks * p.chunk >= pixels
        assert (p.blocks - 1) * p.chunk < pixels
        return
    segs = -(-w // p.step)
    assert segs * p.step >= w > (segs - 1) * p.step
    assert p.units == n * h * segs
    assert p.tiles == -(-c // p.tile_c) * -(-d // p.tile_d)
    ranges = np.array([p.block_range(b) for b in range(p.blocks)])
    assert ranges[0, 0] == 0 and ranges[-1, 1] == p.total
    assert (ranges[1:, 0] == ranges[:-1, 1]).all() and (ranges[:, 1] > ranges[:, 0]).all()
    ids = []
    for t in range(p.tiles):
        lo, hi = t * p.units, (t + 1) * p.units
        meet = [b for b, (s, e) in enumerate(ranges) if s < hi and e > lo]
        assert p.blocks_of_tile(t) == (meet[0], meet[-1])
        assert meet == list(range(meet[0], meet[-1] + 1))
        ids += [b + t for b in meet]
    assert len(set(ids)) == len(ids) and max(ids) < p.pieces


def test_wgrad_plan_covers_every_pixel():
    for shape in [(5, 480, 854, 64, 64), (5, 30, 54, 512, 512),
                  (5, 480, 854, 3, 64), (2, 9, 13, 8, 4), (1, 1, 1, 1, 1),
                  (1, 1, 1, 8, 8), (2, 17, 23, 64, 16), (1, 7, 100, 128, 192)]:
        p = wgrad.plan(*shape)
        assert p.path == ("tma" if shape[3] % 8 == 0 and shape[4] % 8 == 0
                          else "wmma")
        if p.path == "wmma":
            assert p.tile_c == (16 if shape[3] <= 16 else 64)
        _assert_covers_every_pixel(p, shape)


def _trunk_and_side_shapes(n, h, w):
    """(N, H, W, C, D) of the trunk convs after the stem and of the C -> 16
    side convs of stages 2-5, at ModelConfig()'s widths."""
    cfg = ModelConfig()
    hw = []
    for _ in cfg.stages:
        hw.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    trunk, cin = [], 3
    for i, stage in enumerate(cfg.stages):
        for cout in stage:
            trunk.append((n, *hw[i], cin, cout))
            cin = cout
    sides = [(n, *hw[i], cfg.stages[i][-1], cfg.side_channels)
             for i in range(1, len(cfg.stages))]
    return trunk[1:], sides


_MAIN = (_trunk_and_side_shapes(5, 480, 854)[0]
         + _trunk_and_side_shapes(2, 480, 854)[0]
         + _trunk_and_side_shapes(5, 480, 854)[1])
_UNALIGNED = [(2, 9, 13, 8, 4), (2, 17, 23, 3, 64), (2, 17, 29, 12, 8)]


@pytest.mark.parametrize("shape", _MAIN + _UNALIGNED)
def test_wgrad_plan_path_and_grid(shape):
    """Every trunk conv after the stem (batch 5 and 2, 480x854) and every
    side conv takes the Hopper path with at least one block per SM of an
    H100; the shapes with C or D off a multiple of 8 take the wmma path.
    The runs cover every pixel once."""
    p = wgrad.plan(*shape)
    if shape in _UNALIGNED:
        assert p.path == "wmma"
    else:
        assert p.path == "tma" and p.blocks >= wgrad.NUM_SMS == 132
        assert p.tile_d == (16 if shape[4] == 16 else 64)
    _assert_covers_every_pixel(p, shape)


def test_wgrad_plan_shapes_are_the_models():
    """The 12 trunk and 4 side shapes the plan test takes are the convs of
    the full model: 13 convs with the stem, 16 side channels."""
    trunk, sides = _trunk_and_side_shapes(5, 480, 854)
    assert len(trunk) == 12 and len(sides) == 4
    assert trunk[0] == (5, 480, 854, 64, 64) and trunk[-1] == (5, 30, 54, 512, 512)
    assert [s[3:] for s in sides] == [(128, 16), (256, 16), (512, 16), (512, 16)]


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
