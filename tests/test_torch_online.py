"""The port's online fine-tune against the JAX package's, step for step.

From the same weights and the same augmentation stream (the JAX chunk's
PRNG draws replayed into the port's ``Draws``), ``make_chunk_fn`` runs
several grouped-SGD steps on each side and the per-step losses and the
parameter deltas are compared, with the bounds of
``tests/test_train_parity.py``:

- parity (float32, TF32 off): losses within rtol 2e-4, each leaf's delta
  within 5e-3 of that leaf's delta scale (float32 sums in another order);
- fast (bf16 trunk): losses within rtol 5e-2 and the two-term bf16 bound on
  the deltas, max(0.2 of the leaf's scale, 0.075 of the largest delta):
  cuDNN-style and XLA bf16 convs may round an activation the other way,
  and that noise compounds over the steps on the deep, barely moving
  leaves.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.configs import OnlineConfig as JaxOnlineConfig
from osvos_tpu.train import online as jax_online
from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.train import online

TINY_STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))
SIDE_CH = 8
POOL = 3
H, W = 33, 49
CFG = OnlineConfig(n_steps=4, n_ave_grad=2, lr=1e-5, weight_decay=2e-4,
                   momentum=0.9, hflip_prob=0.5, seed=0)


def _model_config(compute_mode):
    return ModelConfig(stages=TINY_STAGES, side_channels=SIDE_CH,
                       compute_mode=compute_mode)


def _blob(cy, cx, r):
    yy, xx = np.mgrid[:H, :W]
    return (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)[..., None]


@functools.lru_cache(maxsize=None)
def _setup():
    """Weights, a pool of three (image, mask) pairs (about 15% foreground)
    and the JAX step keys."""
    state0 = init_osvos_params(_model_config("parity"),
                               torch.Generator().manual_seed(11))
    rng = np.random.RandomState(5)
    imgs = (rng.randn(POOL, H, W, 3) * 40).astype(np.float32)
    masks = np.stack([_blob(16, 16, 11), _blob(14, 22, 10), _blob(19, 18, 12)])
    keys = jax.random.split(jax.random.PRNGKey(7), CFG.n_steps)
    return state0, imgs, masks, keys


def _replay_draws(keys, aug_mode):
    """The draws the JAX chunk makes from ``keys``
    (``osvos_tpu/train/online.py`` ``draw``), as the port's ``Draws``. Both
    step modes split each step key into ``n_ave_grad`` sample keys."""
    rows = []
    for s in range(len(keys)):
        row = []
        for k in jax.random.split(keys[s], CFG.n_ave_grad):
            if aug_mode == "pool":
                ki, kf = jax.random.split(k)
                row.append((float(jax.random.uniform(kf) < CFG.hflip_prob),
                            int(jax.random.randint(ki, (), 0, POOL))))
            else:
                kf, kr, ks = jax.random.split(k, 3)
                row.append((
                    float(jax.random.uniform(kf) < CFG.hflip_prob),
                    float(jax.random.uniform(kr, minval=CFG.rots[0],
                                             maxval=CFG.rots[1])),
                    float(jax.random.uniform(ks, minval=CFG.scales[0],
                                             maxval=CFG.scales[1]))))
        rows.append(row)
    cols = np.array(rows).transpose(2, 0, 1)
    flip = torch.from_numpy(cols[0] > 0.5)
    if aug_mode == "pool":
        return online.Draws(flip=flip, index=torch.from_numpy(cols[1].astype(np.int64)))
    return online.Draws(flip=flip,
                        angle=torch.from_numpy(cols[1].astype(np.float32)),
                        scale=torch.from_numpy(cols[2].astype(np.float32)))


def _run_jax(cfg, model_cfg, state0, imgs, masks, keys, aug_mode, step_mode):
    jcfg_m = JaxModelConfig(**dataclasses.asdict(model_cfg))
    jcfg = JaxOnlineConfig(**dataclasses.asdict(cfg))
    params = jax.tree.map(jnp.asarray, params_to_jax(state0))
    chunk = jax.jit(jax_online.make_chunk_fn(jcfg_m, jcfg, aug_mode=aug_mode,
                                             step_mode=step_mode))
    tx = jax_online.make_online_optimizer(params, jcfg, step_mode)
    p, _, losses = chunk(params, tx.init(params), jnp.asarray(imgs),
                         jnp.asarray(masks), keys)
    return jax.tree.map(np.asarray, p), np.asarray(losses)


def _run_port(cfg, model_cfg, state0, imgs, masks, draws, aug_mode, step_mode):
    model = OSVOS(model_cfg)
    model.load_state_dict(state0)
    chunk = online.make_chunk_fn(model_cfg, cfg, aug_mode, step_mode)
    losses = chunk(model, online.make_online_optimizer(model, cfg),
                   torch.from_numpy(imgs), torch.from_numpy(masks), draws)
    return params_to_jax(model), losses.numpy()


CASES = [
    (aug, step, mode, impl)
    for step in ("microbatch", "sequential")
    for mode in ("parity", "fast")
    for impl in ("xla", "pallas")
    for aug in ("pool",)
] + [("per_step", "microbatch", "parity", "xla")]


@pytest.mark.parametrize("aug_mode,step_mode,compute_mode,loss_impl", CASES)
def test_chunk_trajectory_matches_jax(aug_mode, step_mode, compute_mode,
                                      loss_impl):
    state0, imgs, masks, keys = _setup()
    if aug_mode == "per_step":
        imgs, masks = imgs[:1], masks[:1]
    cfg = dataclasses.replace(CFG, loss_impl=loss_impl)
    model_cfg = _model_config(compute_mode)
    want, want_losses = _run_jax(cfg, model_cfg, state0, imgs, masks, keys,
                                 aug_mode, step_mode)
    got, got_losses = _run_port(cfg, model_cfg, state0, imgs, masks,
                                _replay_draws(keys, aug_mode), aug_mode,
                                step_mode)

    parity = compute_mode == "parity"
    assert got_losses.shape == (CFG.n_steps,) and np.isfinite(got_losses).all()
    np.testing.assert_allclose(got_losses, want_losses,
                               rtol=2e-4 if parity else 5e-2)

    p0 = params_to_jax(state0)
    deltas = {(m, k): (got[m][k] - p0[m][k], want[m][k] - p0[m][k])
              for m in p0 for k in p0[m]}
    gmax = max(float(np.abs(dw).max()) for _, dw in deltas.values())
    assert gmax > 0, "training moved nothing; the test is vacuous"
    for (m, k), (dg, dw) in deltas.items():
        scale = float(np.abs(dw).max())
        if m.startswith("score_dsn"):  # not in the 'infer' graph: weight decay only
            assert scale == 0 or k == "kernel", (m, k)
        atol = 5e-3 * scale if parity else max(0.2 * scale, 0.075 * gmax)
        np.testing.assert_allclose(dg, dw, rtol=0, atol=max(atol, 1e-12),
                                   err_msg=f"parameter delta of {m}.{k}")


def test_leaves_outside_the_graph_still_decay():
    """score_dsn is not in the 'infer' graph, so its gradient is zero; the
    JAX package's optimizer still decays it: after one step the weight is
    p * (1 - lr * 0.1 * wd) (dsn_w: lr x0.1, wd x1) and the bias, without
    decay, stays."""
    model_cfg = _model_config("parity")
    cfg = dataclasses.replace(CFG, n_steps=1, lr=1e-2, weight_decay=0.5)
    state0, imgs, masks, _ = _setup()
    model = OSVOS(model_cfg)
    model.load_state_dict(state0)
    chunk = online.make_chunk_fn(model_cfg, cfg)
    draws = online.make_draws(cfg, "pool", 1, POOL,
                              torch.Generator().manual_seed(0), "cpu")
    chunk(model, online.make_online_optimizer(model, cfg),
          torch.from_numpy(imgs), torch.from_numpy(masks), draws)
    w0 = state0["score_dsn1.weight"]
    torch.testing.assert_close(model.score_dsn1.weight.detach(),
                               w0 * (1 - cfg.lr * 0.1 * cfg.weight_decay),
                               rtol=1e-6, atol=0)
    assert not torch.equal(model.score_dsn1.weight.detach(), w0)
    assert torch.equal(model.score_dsn1.bias.detach(),
                       state0["score_dsn1.bias"])


def test_make_fine_tune_fn_runs_on_cpu_and_moves_parameters():
    model_cfg = _model_config("fast")
    cfg = dataclasses.replace(CFG, n_steps=2, loss_impl="pallas")
    state0, imgs, masks, _ = _setup()
    model = OSVOS(model_cfg)
    model.load_state_dict(state0)
    fine_tune = online.make_fine_tune_fn(model_cfg, cfg, pool_size=4,
                                         device="cpu")
    losses = fine_tune(model, imgs[0], masks[0, ..., 0],
                       torch.Generator().manual_seed(0))
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, state0[k])}
    for prefix in ("stage1_conv0", "stage5_conv2", "side_prep1", "fuse"):
        assert f"{prefix}.weight" in moved, prefix


def test_run_online_per_step_runs_in_chunks_and_keeps_the_parent():
    model_cfg = _model_config("parity")
    cfg = dataclasses.replace(CFG, n_steps=3, scan_chunk=2)
    state0, imgs, masks, _ = _setup()
    parent = {k: v.clone() for k, v in state0.items()}
    result = online.run_online(parent, imgs[0], masks[0], model_cfg, cfg,
                               aug_mode="per_step", device="cpu")
    assert result.losses.shape == (3,)
    assert bool(torch.isfinite(result.losses).all())
    assert all(torch.equal(parent[k], state0[k]) for k in state0)
    assert not torch.equal(result.params["fuse.weight"], state0["fuse.weight"])


def test_run_online_pool_mode_waits_for_the_loaders():
    """The host pool came with the loaders: pool mode runs in chunks from
    the parent state, which it leaves as it was, and its default draws
    index the whole pool."""
    model_cfg = _model_config("parity")
    cfg = dataclasses.replace(CFG, n_steps=3, scan_chunk=2)
    state0, imgs, masks, _ = _setup()
    parent = {k: v.clone() for k, v in state0.items()}
    result = online.run_online(parent, imgs[0], masks[0], model_cfg, cfg,
                               aug_mode="pool", pool_size=4, device="cpu")
    assert result.losses.shape == (3,)
    assert bool(torch.isfinite(result.losses).all())
    assert all(torch.equal(parent[k], state0[k]) for k in state0)
    assert not torch.equal(result.params["fuse.weight"], state0["fuse.weight"])


def test_entry_points_need_cuda_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        online.make_fine_tune_fn(_model_config("fast"), CFG)
    with pytest.raises(ValueError):
        online.make_chunk_fn(_model_config("fast"), CFG, aug_mode="host")


def test_make_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    pool = online.make_draws(CFG, "pool", 50, POOL, gen, "cpu")
    assert pool.index.shape == pool.flip.shape == (50, CFG.n_ave_grad)
    assert int(pool.index.min()) == 0 and int(pool.index.max()) == POOL - 1
    per = online.make_draws(CFG, "per_step", 50, 1, gen, "cpu")
    assert per.angle.shape == (50, CFG.n_ave_grad) and per.index is None
    assert float(per.scale.min()) >= 0.75 and float(per.scale.max()) <= 1.25
