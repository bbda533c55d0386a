"""Checkpoints, DAVIS J/F and synthetic frames of the port against the JAX
package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.data import synthetic as jax_synthetic
from osvos_tpu.evaluation import davis_j as jax_davis_j
from osvos_tpu.utils.checkpoint import save_checkpoint
from osvos_torch.configs import ModelConfig
from osvos_torch.data import synthetic
from osvos_torch.evaluation import davis_j
from osvos_torch.models import OSVOS, params_to_jax
from osvos_torch.utils.checkpoint import load_checkpoint, read_msgpack_tree

from tests.torch_oracle import TorchOSVOS

TINY8 = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                            (16, 16, 16)), side_channels=8)


def _random_tree(rng, cfg):
    return {name: {k: rng.randn(*v.shape).astype(np.float32)
                   for k, v in leaf.items()}
            for name, leaf in params_to_jax(OSVOS(cfg).state_dict()).items()}


def test_ckpt_from_jax_reads_back_bit_equal(tmp_path, rng):
    tree = _random_tree(rng, TINY8)
    path = str(tmp_path / "seq_online.ckpt")
    save_checkpoint(path, jax.tree.map(jnp.asarray, tree), step=17)
    state = load_checkpoint(path)
    back = params_to_jax(state)
    for name in tree:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k], tree[name][k])
    OSVOS(TINY8).load_state_dict(state)
    assert read_msgpack_tree(path)["step"] == 17


def test_ckpt_chunked_arrays(tmp_path, rng, monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE into chunk dicts."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"fuse": {"kernel": rng.randn(1, 1, 40, 1).astype(np.float32),
                     "bias": np.float32([0.25])}}
    path = str(tmp_path / "chunked.ckpt")
    save_checkpoint(path, tree)
    got = read_msgpack_tree(path)["params"]
    np.testing.assert_array_equal(got["fuse"]["kernel"], tree["fuse"]["kernel"])
    np.testing.assert_array_equal(got["fuse"]["bias"], tree["fuse"]["bias"])


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_reference_state_dict_files(tmp_path, suffix):
    torch.manual_seed(3)
    net = TorchOSVOS(stages=TINY8.stages, side_channels=TINY8.side_channels)
    path = str(tmp_path / f"parent{suffix}")
    if suffix == ".pth":
        torch.save(net.state_dict(), path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in net.state_dict().items()})
    state = load_checkpoint(path, TINY8)
    torch.testing.assert_close(state["stage2_conv1.weight"],
                               net.stages[1][3].weight.detach(), rtol=0, atol=0)
    torch.testing.assert_close(state["fuse.bias"], net.fuse.bias.detach(),
                               rtol=0, atol=0)
    OSVOS(TINY8).load_state_dict(state)


def _masks(rng, n, h=60, w=90):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        cy, cx, r = rng.uniform(10, 50), rng.uniform(10, 80), rng.uniform(5, 25)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
        m[rng.rand(h, w) < 0.02] ^= 1  # ragged edges and specks
        out.append(m)
    return out


@pytest.mark.parametrize("bound_th", [0.008, 3, 0.05])
def test_davis_j_and_f_equal_jax(rng, bound_th):
    anns, segs = _masks(rng, 5), _masks(rng, 5)
    segs[1] = anns[1].copy()
    segs[2] = np.zeros_like(anns[2])
    for a, s in zip(anns, segs):
        assert davis_j.db_eval_iou(a, s) == jax_davis_j.db_eval_iou(a, s)
        np.testing.assert_array_equal(davis_j.seg2bmap(s), jax_davis_j.seg2bmap(s))
        assert (davis_j.boundary_f_measure(a, s, bound_th)
                == jax_davis_j.boundary_f_measure(a, s, bound_th))
    assert davis_j.evaluate_sequence(anns, segs) == \
        jax_davis_j.evaluate_sequence(anns, segs)


@pytest.mark.parametrize("args", [(48, 80, 0.0, 2), (65, 97, 1.05, 13),
                                  (480, 854, 0.7, 0)])
def test_synthetic_frame_equals_jax(args):
    img, mask = synthetic._frame(*args)
    want_img, want_mask = jax_synthetic._frame(*args)
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(mask, want_mask)


def test_image_like_preprocesses_like_bench():
    from osvos_tpu.configs import MEANVAL_BGR

    got = synthetic.image_like(2, 32, 48, seed0=5)
    want = np.stack([jax_synthetic._frame(32, 48, t=0.7 * i, seed=5 + i)[0]
                     for i in range(2)]).astype(np.float32)
    want = want[..., ::-1] - np.asarray(MEANVAL_BGR, np.float32)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
