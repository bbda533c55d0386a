"""The port's grouped SGD against the JAX package's ``make_osvos_optimizer``:
the same group of every parameter, and the same parameters after three
steps from the same gradients, without and with gradient accumulation
(``optax.MultiSteps`` there; summed ``loss / n`` gradients, as the online
fine-tune does, or the ``MultiSteps`` wrapper of parent training here).
Tolerance: rtol 1e-6 on the parameters, with 1e-6 of the leaf's largest
value as the floor for entries near zero, and 1e-5 of each leaf's movement
on the deltas (float32 updates rounded in another order: torch applies
``p - lr * buf`` in one fused step, optax rounds ``-lr * buf`` first)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.train import optim as jax_optim
from osvos_torch.configs import ModelConfig
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.train import optim

TINY8 = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                            (16, 16, 16)), side_channels=8)
LR, MOMENTUM, WD = 0.05, 0.9, 0.01


def _model(seed=0):
    model = OSVOS(TINY8)
    model.load_state_dict(init_osvos_params(TINY8, torch.Generator().manual_seed(seed)))
    return model


def _jax_leaf(name):
    module, leaf = name.rsplit(".", 1)
    return module, "kernel" if leaf == "weight" else "bias"


def test_group_labels_equal_jax():
    model = _model()
    tree = params_to_jax(model)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: jax_optim.param_group_label(path), tree)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree.leaves(tree))
    for name in names:
        module, leaf = _jax_leaf(name)
        assert optim.param_group_label(name) == labels[module][leaf], name
    assert optim.REFERENCE_GROUPS == dict(jax_optim.REFERENCE_GROUPS)
    with pytest.raises(ValueError):
        optim.param_group_label("upscale1.weight")


@pytest.mark.parametrize("n_ave_grad", [1, 3])
def test_three_steps_equal_jax(rng, n_ave_grad):
    model = _model()
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    tree = jax.tree.map(jnp.asarray, params_to_jax(model))
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3 * n_ave_grad)]

    tx = jax_optim.make_osvos_optimizer(tree, LR, MOMENTUM, WD,
                                        n_ave_grad=n_ave_grad)
    state = tx.init(tree)
    params = tree
    for g in grads:
        g_tree = params_to_jax({k: torch.from_numpy(v) for k, v in g.items()})
        updates, state = tx.update(jax.tree.map(jnp.asarray, g_tree), state,
                                   params)
        params = jax.tree.map(lambda a, b: a + b, params, updates)

    opt = optim.make_osvos_optimizer(model.named_parameters(), LR, MOMENTUM, WD)
    assert {pg["label"] for pg in opt.param_groups} == set(optim.REFERENCE_GROUPS)
    named = dict(model.named_parameters())
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        for g in grads[step * n_ave_grad:(step + 1) * n_ave_grad]:
            for k, p in named.items():  # what backward of loss / n adds
                grad = torch.from_numpy(g[k]) / n_ave_grad
                p.grad = grad if p.grad is None else p.grad + grad
        opt.step()

    for k, p in named.items():
        module, leaf = _jax_leaf(k)
        want = np.asarray(params[module][leaf])
        got = params_to_jax({k: p.detach()})[module][leaf]
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
        start = params_to_jax({k: p0[k]})[module][leaf]
        moved = np.abs(want - start).max()
        assert moved > 0, k
        np.testing.assert_allclose(got - start, want - start, rtol=0,
                                   atol=1e-5 * moved, err_msg=k)


def test_multisteps_equals_optax_multisteps_call_by_call(rng):
    """``MultiSteps(k=3)`` over seven calls: after every call the same
    parameters, ``mini_step`` and running mean as ``optax.MultiSteps``
    (the bounds above); between the k-th calls the parameters stay put.
    Its state survives a round trip through ``state_dict``."""
    model = _model()
    tree = jax.tree.map(jnp.asarray, params_to_jax(model))
    tx = jax_optim.make_osvos_optimizer(tree, LR, MOMENTUM, WD, n_ave_grad=3)
    state, params = tx.init(tree), tree
    named = list(model.named_parameters())
    acc = optim.MultiSteps(named, optim.make_osvos_optimizer(
        named, LR, MOMENTUM, WD), every_k=3)
    for call in range(7):
        g = {k: rng.randn(*p.shape).astype(np.float32) for k, p in named}
        g_tree = params_to_jax({k: torch.from_numpy(v) for k, v in g.items()})
        updates, state = tx.update(jax.tree.map(jnp.asarray, g_tree), state,
                                   params)
        params = jax.tree.map(lambda a, b: a + b, params, updates)
        before = {k: p.detach().clone() for k, p in named}
        acc.zero_grad()
        for k, p in named:  # what backward adds
            p.grad += torch.from_numpy(g[k])
        stepped = acc.step()
        assert stepped == (call % 3 == 2)
        assert acc.mini_step == int(state.mini_step) == (call + 1) % 3
        for i, (k, p) in enumerate(named):
            module, leaf = _jax_leaf(k)
            want = np.asarray(params[module][leaf])
            got = params_to_jax({k: p.detach()})[module][leaf]
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)
            if not stepped:
                assert torch.equal(p.detach(), before[k]), k
            mean = params_to_jax({k: acc.acc_grads[i]})
            np.testing.assert_allclose(
                mean[module][leaf], np.asarray(state.acc_grads[module][leaf]),
                rtol=1e-6, atol=1e-7, err_msg=k)

    saved = acc.state_dict()
    again = optim.MultiSteps(named, optim.make_osvos_optimizer(
        named, LR, MOMENTUM, WD), every_k=3)
    again.load_state_dict(saved)
    assert again.mini_step == 1
    for key in ("acc_grads", "momentum"):
        for k, v in again.state_dict()[key].items():
            assert torch.equal(v, saved[key][k]), (key, k)
    with pytest.raises(ValueError):
        again.load_state_dict({**saved, "mini_step": 3})
