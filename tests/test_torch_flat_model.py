"""The port's flat-trunk OSVOS against the JAX package, at tiny widths.

The JAX package holds its own flat model to its fast model
(``tests/test_flat.py``: forward within 4e-2 of the output's scale, CB-BCE
gradients within 6e-2 of each leaf's scale, the side_prep biases against
parity within 1e-2). The port's flat model is held to the JAX fast and
parity models with the same limits: the two trunks differ in where bf16
rounds (flat: once after the float32 bias add; fast: after the conv and
again after the bias add).

The fine-tune trajectory is held to the JAX fast chunk with the bounds of
``tests/test_torch_online.py``: the JAX flat chunk runs its Pallas kernels
in interpret mode here, minutes for two steps at these widths.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.models import OSVOS as JaxOSVOS
from osvos_tpu.ops.loss import class_balanced_cross_entropy_loss as jax_cbbce
from osvos_torch.configs import ModelConfig
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.models.surgery import spread_head
from osvos_torch.ops.loss import class_balanced_cross_entropy_loss
from osvos_torch.train import online

from tests.test_torch_online import (CFG, _replay_draws, _run_jax, _run_port,
                                     _setup)

TINY = ModelConfig(stages=((8, 8), (12, 12), (16, 16), (16, 16), (16, 16)),
                   side_channels=8, compute_mode="flat")
FRAMES = [(17, 29), (16, 24)]  # odd sizes pool raggedly through every stage


def _jax_apply(cfg, mode, params, x, out_mode):
    jcfg = JaxModelConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, compute_mode=mode)))
    return JaxOSVOS(jcfg).apply({"params": params}, x, mode=out_mode)


def _model(x, seed=0):
    model = OSVOS(TINY)
    model.load_state_dict(init_osvos_params(TINY, torch.Generator().manual_seed(seed)))
    spread_head(model, torch.from_numpy(x))
    return model, jax.tree.map(jnp.asarray, params_to_jax(model))


@pytest.mark.parametrize("hw", FRAMES)
@pytest.mark.parametrize("mode", ["train", "infer", "infer_parts"])
def test_flat_forward_matches_jax_fast(rng, hw, mode):
    """Within 4e-2 of each output's scale."""
    x = (rng.randn(2, *hw, 3) * 10).astype(np.float32)
    model, params = _model(x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode=mode)
    want = _jax_apply(TINY, "fast", params, jnp.asarray(x), mode)
    assert len(got) == len(want) == {"train": 5, "infer": 1, "infer_parts": 5}[mode]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape and g.dtype == np.float32, i
        scale = float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=4e-2 * scale,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("out_mode", ["infer", "train"])
def test_flat_grads_match_jax_fast(rng, out_mode):
    """CB-BCE gradients (the fused output in 'infer', annealed deep
    supervision in 'train'): each leaf within 6e-2 of its scale of the JAX
    fast model's ('infer') or 8e-2 ('train', the limits of
    tests/test_flat.py); the side_prep biases within 1e-2 of the JAX parity
    model's, since the flat head carries their gradient in float32 and the
    fast model rounds it through bf16."""
    h, w = FRAMES[0]
    x = (rng.randn(1, h, w, 3) * 10).astype(np.float32)
    m = (rng.rand(1, h, w, 1) > 0.5).astype(np.float32)
    model, params = _model(x, seed=1)

    def reduce(outs, cbbce):
        if out_mode == "infer":
            return cbbce(outs[-1], m_, size_average=False)
        return (0.5 * sum(cbbce(o, m_, size_average=False) for o in outs[:-1])
                + cbbce(outs[-1], m_, size_average=False))

    m_ = torch.from_numpy(m)
    reduce(model(torch.from_numpy(x), mode=out_mode),
           class_balanced_cross_entropy_loss).backward()
    m_ = jnp.asarray(m)
    want = {mode: jax.jit(jax.grad(lambda p: reduce(
        _jax_apply(TINY, mode, p, jnp.asarray(x), out_mode), jax_cbbce)))(params)
            for mode in ("fast", "parity")}
    checked = 0
    for name, p in model.named_parameters():
        leaf, kind = name.split(".")
        key = "kernel" if kind == "weight" else "bias"
        if leaf.startswith("side_prep") and kind == "bias":
            ref, tol = want["parity"][leaf][key], 1e-2
        else:
            ref, tol = want["fast"][leaf][key], 6e-2 if out_mode == "infer" else 8e-2
        ref = np.asarray(ref)
        if kind == "weight":
            ref = ref.transpose(3, 2, 0, 1)
        got = p.grad.numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * (np.abs(ref).max() + 1e-6),
                                   err_msg=name)
        checked += 1
    assert checked == len(list(model.parameters()))


@pytest.mark.parametrize("step_mode", ["microbatch", "sequential"])
def test_flat_chunk_matches_jax_fast_chunk(step_mode):
    """Two steps of ``make_chunk_fn`` in flat mode from the same weights and
    the JAX chunk's draws: losses within rtol 5e-2 and parameter deltas
    within max(0.2 of the leaf's scale, 0.075 of the largest delta), the
    fast-mode bounds of tests/test_torch_online.py."""
    state0, imgs, masks, keys = _setup()
    keys = keys[:2]
    cfg = dataclasses.replace(CFG, n_steps=2, loss_impl="pallas")
    flat = dataclasses.replace(TINY, stages=((8, 8), (12, 12), (16, 16, 16),
                                             (16, 16, 16), (16, 16, 16)))
    want, want_losses = _run_jax(cfg, dataclasses.replace(flat, compute_mode="fast"),
                                 state0, imgs, masks, keys, "pool", step_mode)
    got, got_losses = _run_port(cfg, flat, state0, imgs, masks,
                                _replay_draws(keys, "pool"), "pool", step_mode)
    assert got_losses.shape == (2,) and np.isfinite(got_losses).all()
    np.testing.assert_allclose(got_losses, want_losses, rtol=5e-2)
    p0 = params_to_jax(state0)
    deltas = {(m, k): (got[m][k] - p0[m][k], want[m][k] - p0[m][k])
              for m in p0 for k in p0[m]}
    gmax = max(float(np.abs(dw).max()) for _, dw in deltas.values())
    assert gmax > 0
    for (m, k), (dg, dw) in deltas.items():
        atol = max(0.2 * float(np.abs(dw).max()), 0.075 * gmax, 1e-12)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=atol,
                                   err_msg=f"parameter delta of {m}.{k}")


def test_flat_fine_tune_runs_on_cpu_and_moves_parameters():
    state0, imgs, masks, _ = _setup()
    cfg_m = dataclasses.replace(TINY, stages=((8, 8), (12, 12), (16, 16, 16),
                                              (16, 16, 16), (16, 16, 16)))
    model = OSVOS(cfg_m)
    model.load_state_dict(state0)
    fine_tune = online.make_fine_tune_fn(
        cfg_m, dataclasses.replace(CFG, n_steps=2, loss_impl="pallas"),
        pool_size=4, device="cpu")
    losses = fine_tune(model, imgs[0], masks[0, ..., 0],
                       torch.Generator().manual_seed(0))
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, state0[k])}
    for prefix in ("stage1_conv0", "stage1_conv1", "stage5_conv2",
                   "side_prep1", "side_prep4", "fuse"):
        assert f"{prefix}.weight" in moved and f"{prefix}.bias" in moved, prefix
