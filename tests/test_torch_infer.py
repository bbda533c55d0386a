"""The port's inference path against the JAX package's: the u8 maps, the
batching of a sequence, and the PNGs."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.evaluation import infer as jax_infer
from osvos_torch.configs import ModelConfig
from osvos_torch.evaluation import infer
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.models.surgery import spread_head
from osvos_torch.ops.kernels import fused_head

TINY = ModelConfig(stages=((4, 4), (6, 6), (8, 8, 8), (8, 8, 8), (8, 8, 8)),
                   side_channels=4)


def _model(cfg, x, seed=2):
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(seed)))
    spread_head(model, torch.from_numpy(x))
    return model


@pytest.mark.parametrize("compute_mode", ["parity", "fast"])
@pytest.mark.parametrize("hw", [(65, 97), (64, 96)])
def test_make_infer_fn_matches_jax(rng, compute_mode, hw):
    """Port (collapsed head, with and without the tail module) vs the JAX
    package's XLA tail, within 1 code."""
    cfg = dataclasses.replace(TINY, compute_mode=compute_mode)
    x = (rng.randn(2, *hw, 3) * 40).astype(np.float32)
    model = _model(cfg, x)
    params = jax.tree.map(jnp.asarray, params_to_jax(model))
    want = np.asarray(jax_infer.make_infer_fn(
        JaxModelConfig(**dataclasses.asdict(cfg)), fused_head=True,
        pallas_tail=False)(params, jnp.asarray(x)))
    assert len(np.unique(want)) >= 100  # not the 127/128 of the reference init
    before = fused_head.launches
    for kernel_tail in (None, True):
        got = infer.make_infer_fn(cfg, kernel_tail=kernel_tail)(
            model, torch.from_numpy(x))
        assert got.dtype == torch.uint8 and got.shape == (2, *hw)
        diff = np.abs(got.numpy().astype(int) - want.astype(int))
        assert diff.max() <= 1, (kernel_tail, diff.max())
    assert fused_head.launches == before  # CPU tensors never launch


def test_unfused_head_matches_fused(rng):
    x = (rng.randn(1, 33, 49, 3) * 40).astype(np.float32)
    model = _model(TINY, x)
    a = infer.make_infer_fn(TINY, fused_head=False)(model, torch.from_numpy(x))
    b = infer.make_infer_fn(TINY)(model, torch.from_numpy(x))
    assert (a.int() - b.int()).abs().max() <= 1


@pytest.mark.parametrize("n_frames", [5, 8, 1])
def test_infer_sequence_pads_the_trailing_batch(rng, n_frames):
    frames = [(rng.randn(33, 49, 3) * 40).astype(np.float32)
              for _ in range(n_frames)]
    model = _model(TINY, np.stack(frames))
    base = infer.make_infer_fn(TINY)
    batches = []

    def spy(m, images):
        batches.append(images.clone())
        return base(m, images)

    out = infer.infer_sequence(model, frames, batch_size=4, infer_fn=spy)
    assert len(out) == n_frames
    assert all(b.shape == (4, 33, 49, 3) for b in batches)
    assert len(batches) == -(-n_frames // 4)
    last = batches[-1]
    n_last = n_frames - 4 * (len(batches) - 1)
    for k in range(n_last, 4):  # padding repeats the last real frame
        torch.testing.assert_close(last[k], last[n_last - 1], rtol=0, atol=0)
    each = [base(model, torch.from_numpy(f[None]))[0].numpy() for f in frames]
    for a, b in zip(out, each):
        assert a.dtype == np.uint8 and np.abs(a.astype(int) - b).max() <= 1


@pytest.mark.parametrize("hw", [(65, 97), (1, 1), (480, 854)])
def test_png_decodes_like_the_jax_writer(tmp_path, rng, hw):
    mask = rng.randint(0, 256, size=hw).astype(np.uint8)
    port_path = str(tmp_path / "port" / "00000.png")
    jax_path = str(tmp_path / "jax" / "00000.png")
    infer.save_mask_png(mask, port_path)
    jax_infer.save_mask_png(mask, jax_path)
    port = cv2.imread(port_path, cv2.IMREAD_UNCHANGED)
    ref = cv2.imread(jax_path, cv2.IMREAD_UNCHANGED)
    assert port.dtype == np.uint8 and port.shape == hw
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, mask)


def test_save_sequence_results_layout(tmp_path, rng):
    masks = [rng.randint(0, 256, size=(5, 7)).astype(np.uint8) for _ in range(3)]
    fnames = [f"/data/JPEGImages/480p/cows/{i:05d}.jpg" for i in range(3)]
    infer.save_sequence_results(masks, fnames, str(tmp_path), "cows")
    assert sorted(os.listdir(tmp_path / "cows")) == [
        "00000.png", "00001.png", "00002.png"]
    got = cv2.imread(str(tmp_path / "cows" / "00002.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, masks[2])
