"""The port's OSVOS against the JAX package's, with the same weights carried
across by params_from_jax / params_to_jax and the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.models import OSVOS as JaxOSVOS
from osvos_tpu.models import load_torch_state_dict as jax_load_torch_state_dict
from osvos_torch.configs import ModelConfig
from osvos_torch.models import (OSVOS, init_osvos_params, load_torch_state_dict,
                                params_from_jax, params_to_jax)
from osvos_torch.models.surgery import spread_head

from tests.torch_oracle import TorchOSVOS

TINY = ModelConfig(stages=((4, 4), (6, 6), (8, 8, 8), (8, 8, 8), (8, 8, 8)),
                   side_channels=4)
TINY8 = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                            (16, 16, 16)), side_channels=8)


def _jax_config(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _models(cfg, x, seed=0):
    """A port model with seeded weights and a spread head, and its weights
    as a JAX parameter tree."""
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(seed)))
    spread_head(model, torch.from_numpy(x))
    return model, jax.tree.map(jnp.asarray, params_to_jax(model))


def _jax_apply(cfg, params, x, mode):
    return JaxOSVOS(_jax_config(cfg)).apply({"params": params}, jnp.asarray(x),
                                            mode=mode)


def test_params_roundtrip_is_exact(rng):
    tree = params_to_jax(OSVOS(TINY8).state_dict())
    tree = {name: {k: rng.randn(*v.shape).astype(np.float32)
                   for k, v in leaf.items()} for name, leaf in tree.items()}
    back = params_to_jax(params_from_jax(tree))
    assert back.keys() == tree.keys()
    for name in tree:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k], tree[name][k])
    model = OSVOS(TINY8)
    model.load_state_dict(params_from_jax(tree))  # names and shapes fit


def test_param_tree_matches_jax_init():
    jax_params = jax.eval_shape(JaxOSVOS(_jax_config(TINY8)).init,
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 48, 3)))["params"]
    tree = params_to_jax(init_osvos_params(TINY8))
    assert tree.keys() == jax_params.keys()
    for name in tree:
        for k in ("kernel", "bias"):
            assert tree[name][k].shape == jax_params[name][k].shape, (name, k)


def test_init_matches_reference_distribution():
    state = init_osvos_params(ModelConfig(), torch.Generator().manual_seed(0))
    assert abs(float(state["side_prep1.weight"].std()) - 0.001) < 3e-4
    assert float(state["fuse.bias"].abs().max()) == 0.0
    w = state["stage3_conv1.weight"]  # lecun: var = 1 / fan_in
    assert abs(float(w.var()) * 9 * 256 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * (9 * 256) ** -0.5 / 0.8796 + 1e-6


@pytest.mark.parametrize("mode", ["flat", "int8"])
def test_unported_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        OSVOS(dataclasses.replace(TINY, compute_mode=mode))


@pytest.mark.parametrize("hw", [(65, 97), (64, 96)])
@pytest.mark.parametrize("mode", ["train", "infer", "infer_parts"])
def test_parity_matches_jax(rng, hw, mode):
    """f32 on both sides: the tolerance of tests/test_model.py (2e-4 of the
    output's scale)."""
    x = (rng.randn(2, *hw, 3) * 40).astype(np.float32)
    model, params = _models(TINY8, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode=mode)
    want = _jax_apply(TINY8, params, x, mode)
    assert len(got) == len(want) == {"train": 5, "infer": 1, "infer_parts": 5}[mode]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, i
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"output {i}")


def test_parity_full_width_matches_jax(rng):
    x = (rng.randn(1, 65, 97, 3) * 40).astype(np.float32)
    model, params = _models(ModelConfig(), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax.jit(lambda p, v: JaxOSVOS(JaxModelConfig()).apply(
        {"params": p}, v))(params, jnp.asarray(x))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_fast_matches_jax_fast(rng, mode):
    """bf16 trunk on both sides. The two frameworks round bf16 at the same
    places (conv output, bias add, ReLU and pool are exact) but their f32
    conv accumulations differ in order, so a value near a bf16 rounding
    boundary can round the other way, one bf16 ulp (2^-8 relative), and the
    difference propagates through 13 convs. Measured: under 1% of the
    output's scale; held at 5%, three times tighter than the rel < 0.15 that
    tests/test_model.py allows between fast and parity."""
    cfg = dataclasses.replace(TINY8, compute_mode="fast")
    x = (rng.randn(2, 65, 97, 3) * 40).astype(np.float32)
    model, params = _models(cfg, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode=mode)
    want = _jax_apply(cfg, params, x, mode)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32
        rel = float(np.abs(g - w).max()) / (float(np.abs(w).max()) + 1e-6)
        assert rel < 0.05, (i, rel)


def test_load_torch_state_dict_matches_jax():
    torch.manual_seed(7)
    net = TorchOSVOS(stages=TINY8.stages, side_channels=TINY8.side_channels)
    state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    want = jax_load_torch_state_dict(state, _jax_config(TINY8))
    got = params_to_jax(load_torch_state_dict(state, TINY8))
    assert got.keys() == want.keys()
    for name in got:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][k], np.asarray(want[name][k]))


def test_load_torch_state_dict_rejects_trained_upsampler():
    torch.manual_seed(7)
    net = TorchOSVOS(stages=TINY8.stages, side_channels=TINY8.side_channels)
    state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    state["upscale.1.weight"] = state["upscale.1.weight"] * 1.01
    with pytest.raises(ValueError, match="frozen bilinear"):
        load_torch_state_dict(state, TINY8)
