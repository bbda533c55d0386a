"""The port's parent training against the JAX package's, at tiny widths.

From the same weights and batches, on the CPU:

- the train step (``make_parent_train_step``): the five losses, their
  annealed total and every gradient, at side_weight 1.0 and 0.25 on an odd
  33x49 frame. A bias gradient sums the cotangent over every pixel with
  much cancellation, so biases are held against the largest bias gradient
  and kernels against their own leaf's scale. Parity (float32, TF32 off):
  losses within rtol 1e-5, kernels within 1e-4, biases within 1e-3
  (measured: 1.3e-6, 2.3e-6 and 9.2e-5; float32 sums in another order).
  Fast (bf16 trunk): losses within rtol 1e-3, kernels and biases within
  5e-2 (measured: 1.3e-6, 1.8e-2 and 1.4e-2): the two round activations at
  the same places, but an activation next to a bf16 boundary may round the
  other way, and the bias adds and their gradients are bf16 in both. The
  flat trunk's train mode against the JAX fast model with
  ``tests/test_torch_flat_model.py``'s bounds;
- ``ParentTrainer`` over 6 calls with ``n_ave_grad=2``, side_weight
  annealed after 3: losses and parameter deltas within the bounds of
  ``tests/test_torch_online.py`` (parity: rtol 2e-4 and 5e-3 of each
  leaf's delta scale; fast: rtol 5e-2 and max(0.2 of the leaf's scale,
  0.075 of the largest delta));
- a batch-n step against n accumulated single calls, a resume from a
  snapshot taken mid-accumulation (bit for bit), a JAX optimizer state
  carried by ``opt_state_from_jax`` (as the trainer bounds), the VGG trunk
  init (exact) and the val loss (parity rtol 1e-5, fast 1e-3);
- the CLI on synthetic frames, and its resume; ``--data_parallel 2``
  without the ranks it needs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.configs import ParentConfig as JaxParentConfig
from osvos_tpu.train import parent as jax_parent
from osvos_tpu.utils.checkpoint import save_checkpoint as jax_save
from osvos_torch.cli import train_parent as cli
from osvos_torch.configs import ModelConfig, ParentConfig
from osvos_torch.models import (OSVOS, init_osvos_params, opt_state_from_jax,
                                params_from_jax, params_to_jax)
from osvos_torch.train import parent
from osvos_torch.utils.checkpoint import load_training_state, save_checkpoint

STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))
H, W = 33, 49
CFG = ParentConfig(batch_size=2, n_ave_grad=2, lr=1e-5, weight_decay=2e-4,
                   momentum=0.9)
SIDE_WEIGHTS = [1.0, 1.0, 1.0, 0.5, 0.5, 0.5]


def _model_config(mode):
    return ModelConfig(stages=STAGES, side_channels=8, compute_mode=mode)


def _jax(cfg):
    cls = JaxParentConfig if isinstance(cfg, ParentConfig) else JaxModelConfig
    return cls(**dataclasses.asdict(cfg))


def _blob(cy, cx, r):
    yy, xx = np.mgrid[:H, :W]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)[..., None]


@functools.lru_cache(maxsize=None)
def _setup():
    """Weights and six batches of two (image, mask) pairs."""
    state0 = init_osvos_params(_model_config("parity"),
                               torch.Generator().manual_seed(11))
    rng = np.random.RandomState(5)
    imgs = (rng.randn(12, H, W, 3) * 40).astype(np.float32)
    masks = np.stack([_blob(10 + i, 14 + 2 * i, 8 + i % 4) for i in range(12)])
    return state0, imgs.reshape(6, 2, H, W, 3), masks.reshape(6, 2, H, W, 1)


def _jax_params(state):
    return jax.tree.map(jnp.asarray, params_to_jax(state))


def _grads_tree(model):
    return params_to_jax({k: p.grad for k, p in model.named_parameters()})


def _assert_grads(got, want, kernel_tol, bias_tol):
    """Kernels within ``kernel_tol`` of their leaf's scale, biases within
    ``bias_tol`` of the largest bias gradient."""
    want = jax.tree.map(np.asarray, want)
    bias_scale = max(float(np.abs(want[m]["bias"]).max()) for m in want)
    for m in want:
        for k, w in want[m].items():
            scale = float(np.abs(w).max()) * kernel_tol if k == "kernel" \
                else bias_scale * bias_tol
            np.testing.assert_allclose(got[m][k], w, rtol=0, atol=scale,
                                       err_msg=f"gradient of {m}.{k}")


@pytest.mark.parametrize("side_weight", [1.0, 0.25])
@pytest.mark.parametrize("mode,impl", [("parity", "xla"), ("fast", "xla"),
                                       ("fast", "pallas")])
def test_train_step_matches_jax(mode, impl, side_weight):
    state0, imgs, masks = _setup()
    cfg_m, cfg = _model_config(mode), dataclasses.replace(CFG, loss_impl=impl)
    loss_fn, _ = parent.make_parent_train_step(cfg_m, cfg)
    model = OSVOS(cfg_m)
    model.load_state_dict(state0)
    total, per = loss_fn(model, torch.from_numpy(imgs[0]),
                         torch.from_numpy(masks[0]), side_weight)
    total.backward()

    jax_loss, _, _ = jax_parent.make_parent_train_step(_jax(cfg_m), _jax(cfg))
    (want_total, want_per), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(_jax_params(state0), jnp.asarray(imgs[0]),
                                 jnp.asarray(masks[0]), jnp.float32(side_weight))
    rtol, ktol, btol = (1e-5, 1e-4, 1e-3) if mode == "parity" \
        else (1e-3, 5e-2, 5e-2)
    assert per.shape == (5,)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want_per), rtol=rtol)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=rtol)
    np.testing.assert_allclose(
        total.item(), side_weight * float(per[:4].sum()) + float(per[4]), rtol=1e-6)
    _assert_grads(_grads_tree(model), want_grads, ktol, btol)


def test_flat_train_step_matches_jax_fast():
    """The flat trunk's train mode (B2-B6's plain versions on the CPU)
    against the JAX fast model: losses within rtol 5e-2 and kernels within
    8e-2 of each leaf's scale (tests/test_torch_flat_model.py's bounds;
    measured: 1.2e-6 and 1.5e-2). The flat trunk keeps every bias gradient
    in float32, where the fast model rounds it through bf16, so the biases
    are held to the JAX parity model's, within 1e-2 of the largest bias
    gradient (measured: 8.9e-5)."""
    state0, imgs, masks = _setup()
    loss_fn, _ = parent.make_parent_train_step(_model_config("flat"), CFG)
    model = OSVOS(_model_config("flat"))
    model.load_state_dict(state0)
    total, per = loss_fn(model, torch.from_numpy(imgs[0]),
                         torch.from_numpy(masks[0]), 0.5)
    total.backward()
    want = {}
    for mode in ("fast", "parity"):
        jax_loss, _, _ = jax_parent.make_parent_train_step(
            _jax(_model_config(mode)), _jax(CFG))
        want[mode] = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            _jax_params(state0), jnp.asarray(imgs[0]), jnp.asarray(masks[0]),
            jnp.float32(0.5))
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want["fast"][0][1]),
                               rtol=5e-2)
    got = _grads_tree(model)
    fast, parity = (jax.tree.map(np.asarray, want[m][1]) for m in ("fast", "parity"))
    bias_scale = max(float(np.abs(parity[m]["bias"]).max()) for m in parity)
    for m, leaf in got.items():
        np.testing.assert_allclose(
            leaf["kernel"], fast[m]["kernel"], rtol=0,
            atol=8e-2 * np.abs(fast[m]["kernel"]).max(), err_msg=f"{m}.kernel")
        np.testing.assert_allclose(leaf["bias"], parity[m]["bias"], rtol=0,
                                   atol=1e-2 * bias_scale, err_msg=f"{m}.bias")


def _run_port(mode, state0, imgs, masks, calls=range(6), trainer=None,
              cfg=CFG):
    trainer = trainer or parent.ParentTrainer(state0, _model_config(mode), cfg,
                                              device="cpu")
    losses = [float(trainer.train_step(imgs[i], masks[i],
                                       SIDE_WEIGHTS[i])["total"]) for i in calls]
    return trainer, np.array(losses)


def _run_jax(mode, state0, imgs, masks, calls=range(6), trainer=None):
    trainer = trainer or jax_parent.ParentTrainer(
        _jax_params(state0), _jax(_model_config(mode)), _jax(CFG))
    losses = [float(trainer.train_step(imgs[i], masks[i],
                                       SIDE_WEIGHTS[i])["total"]) for i in calls]
    return trainer, np.array(losses)


def _assert_trajectory(mode, state0, got_params, want_params, got_losses,
                       want_losses):
    parity = mode == "parity"
    np.testing.assert_allclose(got_losses, want_losses,
                               rtol=2e-4 if parity else 5e-2)
    p0, got = params_to_jax(state0), params_to_jax(got_params)
    want = jax.tree.map(np.asarray, want_params)
    deltas = {(m, k): (got[m][k] - p0[m][k], want[m][k] - p0[m][k])
              for m in p0 for k in p0[m]}
    gmax = max(float(np.abs(dw).max()) for _, dw in deltas.values())
    assert gmax > 0, "training moved nothing; the test is vacuous"
    for (m, k), (dg, dw) in deltas.items():
        scale = float(np.abs(dw).max())
        atol = 5e-3 * scale if parity else max(0.2 * scale, 0.075 * gmax)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=max(atol, 1e-12),
                                   err_msg=f"parameter delta of {m}.{k}")


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_trainer_matches_jax_trainer(mode):
    """Six calls, an optimizer step on every second; the parameters do not
    move on the calls between."""
    state0, imgs, masks = _setup()
    trainer, losses = _run_port(mode, state0, imgs, masks, calls=range(1))
    assert all(torch.equal(v, state0[k]) for k, v in trainer.params.items())
    assert trainer.opt_state["mini_step"] == 1
    trainer, rest = _run_port(mode, state0, imgs, masks, calls=range(1, 6),
                              trainer=trainer)
    want, want_losses = _run_jax(mode, state0, imgs, masks)
    _assert_trajectory(mode, state0, trainer.params, want.params,
                       np.concatenate([losses, rest]), want_losses)


def test_batch_step_equals_accumulated_single_calls():
    """One batch-3 call with n_ave_grad=1 equals three batch-1 calls with
    n_ave_grad=3 (mirrors tests/test_training.py's JAX test, its bounds)."""
    state0, imgs, masks = _setup()
    x, y = imgs.reshape(12, H, W, 3)[:3], masks.reshape(12, H, W, 1)[:3]
    cfg_m = _model_config("parity")
    batch = parent.ParentTrainer(state0, cfg_m, dataclasses.replace(
        CFG, batch_size=3, n_ave_grad=1), device="cpu")
    batch.train_step(x, y, side_weight=1.0)
    single = parent.ParentTrainer(state0, cfg_m, dataclasses.replace(
        CFG, batch_size=1, n_ave_grad=3), device="cpu")
    for b in range(3):
        single.train_step(x[b:b + 1], y[b:b + 1], side_weight=1.0)
    for k, v in batch.params.items():
        assert not torch.equal(v, state0[k]) or k.startswith("score_dsn"), k
        np.testing.assert_allclose(v.numpy(), single.params[k].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_resume_mid_accumulation_is_exact(tmp_path):
    """A snapshot after call 3 (mini_step 1 of 2), reloaded into a fresh
    trainer, finishes the six calls bit for bit as the run without it."""
    state0, imgs, masks = _setup()
    straight, losses = _run_port("fast", state0, imgs, masks)
    first, head = _run_port("fast", state0, imgs, masks, calls=range(3))
    assert first.opt_state["mini_step"] == 1
    path = save_checkpoint(str(tmp_path / "snap.pt"), first.params,
                           first.opt_state, step=2)
    params, opt_state, step = load_training_state(path)
    assert step == 2
    fresh = parent.ParentTrainer(init_osvos_params(
        _model_config("fast"), torch.Generator().manual_seed(99)),
        _model_config("fast"), CFG, device="cpu")
    fresh.load(params, opt_state)
    fresh, tail = _run_port("fast", state0, imgs, masks, calls=range(3, 6),
                            trainer=fresh)
    np.testing.assert_array_equal(np.concatenate([head, tail]), losses)
    for k, v in straight.params.items():
        assert torch.equal(fresh.params[k], v), k
    for key in ("acc_grads", "momentum"):
        for k, v in straight.opt_state[key].items():
            assert torch.equal(fresh.opt_state[key][k], v), (key, k)


def test_jax_opt_state_carries_over(tmp_path):
    """Three JAX calls (mid-accumulation), then the JAX state carried into
    the port, through ``opt_state_from_jax`` and through a JAX ``.ckpt``:
    the last three calls follow the JAX trainer's (trainer bounds)."""
    state0, imgs, masks = _setup()
    jt, _ = _run_jax("parity", state0, imgs, masks, calls=range(3))
    opt = jax.tree.map(np.asarray, serialization.to_state_dict(jt.opt_state))
    params = params_from_jax(jax.tree.map(np.asarray, jt.params))
    carried = opt_state_from_jax(opt)
    assert carried["mini_step"] == 1
    path = str(tmp_path / "jax.ckpt")
    jax_save(path, jt.params, jt.opt_state, step=2)
    p_ckpt, o_ckpt, step = load_training_state(path)
    assert step == 2 and o_ckpt["mini_step"] == 1
    for key in ("acc_grads", "momentum"):
        assert any(float(v.abs().max()) > 0 for v in carried[key].values())
        for k, v in carried[key].items():
            assert torch.equal(o_ckpt[key][k], v), (key, k)
    trainer = parent.ParentTrainer(p_ckpt, _model_config("parity"), CFG,
                                   device="cpu")
    trainer.load(params, carried)
    trainer, got_losses = _run_port("parity", state0, imgs, masks,
                                    calls=range(3, 6), trainer=trainer)
    jt, want_losses = _run_jax("parity", state0, imgs, masks,
                               calls=range(3, 6), trainer=jt)
    _assert_trajectory("parity", params, trainer.params, jt.params,
                       got_losses, want_losses)


def test_trunk_weights_init_matches_jax():
    """torchvision VGG-16 ``features`` convs (seeded random stand-ins at
    the tiny widths, ReLU and pool slots skipped) land on the trunk in
    index order, exactly as the JAX package's ``_apply_vgg_features`` puts
    them; the other layers keep their init."""
    from osvos_tpu.models.surgery import _apply_vgg_features

    cfg_m = _model_config("parity")
    rng = np.random.RandomState(3)
    feats, idx = {}, 0
    for widths in cfg_m.stages:
        for width in widths:
            cin = 3 if idx == 0 else last
            feats[f"features.{idx}.weight"] = rng.randn(width, cin, 3, 3).astype(np.float32)
            feats[f"features.{idx}.bias"] = rng.randn(width).astype(np.float32)
            last, idx = width, idx + 2
        idx += 1  # the pool slot
    feats["classifier.0.weight"] = rng.randn(4, 4).astype(np.float32)
    plain = init_osvos_params(cfg_m, torch.Generator().manual_seed(0))
    got = init_osvos_params(cfg_m, torch.Generator().manual_seed(0),
                            trunk_weights=feats)
    want = params_from_jax(_apply_vgg_features(params_to_jax(plain), feats,
                                               _jax(cfg_m)))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], plain[k]) != k.startswith("stage"), k
    trunk = [k for k in want if k.startswith("stage")]
    as_tensors = init_osvos_params(cfg_m, trunk_weights={
        k: torch.from_numpy(v) for k, v in feats.items()})
    assert all(torch.equal(as_tensors[k], got[k]) for k in trunk)
    feats["features.0.weight"] = feats["features.0.weight"][:, :2]
    with pytest.raises(ValueError, match="features.0.weight"):
        init_osvos_params(cfg_m, trunk_weights=feats)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_val_loss_matches_jax(mode):
    state0, imgs, masks = _setup()
    port = parent.ParentTrainer(state0, _model_config(mode), CFG, device="cpu")
    jt = jax_parent.ParentTrainer(_jax_params(state0), _jax(_model_config(mode)),
                                  _jax(CFG))
    got = port.val_loss(imgs[1], masks[1])
    np.testing.assert_allclose(got, jt.val_loss(imgs[1], masks[1]),
                               rtol=1e-5 if mode == "parity" else 1e-3)
    assert got > 0


def _epochs(out):
    return [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("[epoch")]


def test_cli_trains_probes_snapshots_and_resumes(tmp_path, capsys):
    args = ["--synthetic", "8", "--tiny", "--device", "cpu", "--epochs", "2",
            "--n_ave_grad", "2", "--test_interval", "1", "--snapshot", "2",
            "--input_h", "96", "--input_w", "160", "--lr", "1e-4",
            "--save_root", str(tmp_path)]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    losses = _epochs(out)
    assert len(losses) == 2 and losses[1] < losses[0], out
    assert out.count("val loss=") == 2
    snap = tmp_path / "models" / "parent_epoch-1.pt"
    assert f"snapshot -> {snap}" in out and snap.exists()
    assert (tmp_path / "logs_parent" / "scalars.jsonl").exists()

    resumed = args[:args.index("--epochs") + 1] + ["3"] + \
        args[args.index("--epochs") + 2:] + ["--resume", str(snap)]
    assert cli.main(resumed) == 0
    out = capsys.readouterr().out
    assert "after epoch 1" in out and "[epoch 2]" in out and "[epoch 1]" not in out
    assert (tmp_path / "models" / "parent_epoch-2.pt").exists()


def test_cli_data_parallel_needs_as_many_ranks(monkeypatch):
    """``--data_parallel 2`` in a one-rank world (no process group) names
    the ranks it needs and how to start them."""
    monkeypatch.delenv("OSVOS_MULTIHOST", raising=False)
    with pytest.raises(RuntimeError, match=r"needs 2 ranks, but the world has "
                       r"1.*torchrun --nproc_per_node 2"):
        cli.main(["--synthetic", "2", "--data_parallel", "2", "--device", "cpu"])
