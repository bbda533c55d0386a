"""The port's DAVIS reader, host augmentation pool and pool-mode fine-tune
against the JAX package's (OpenCV).

- ``DAVIS2016``: on synthetic trees written by either package's
  ``generate`` (OpenCV's JPEG encoder or the port's), the same ``img_list``,
  ``labels`` and samples; images and gts bit for bit at the native size
  (the port's JPEG decoder equals OpenCV's, ``tests/test_torch_image_io.py``).
  With ``input_res`` the image is bilinear in float32 where OpenCV works
  in fixed point: within one code; the gts (nearest) are equal.
- ``build_host_pool``: the same draws from ``random.Random(seed)``; warps
  within ``tests/test_torch_transforms.py``'s bounds (images 1e-3 on the
  0-255 scale, gts equal on all but 1e-3 of the pixels).
- ``run_online(aug_mode='pool')`` from the same parent with the JAX PRNG's
  draws replayed: parity mode at ``tests/test_torch_online.py``'s bounds
  (losses rtol 2e-4, deltas within 5e-3 of each leaf's delta scale).
- Parent training from ``--db_root``: the port's pipeline over
  ``DAVIS2016(train=True)`` gives the JAX pipeline's batches within the
  transforms' bounds, and the CLI trains from a DAVIS tree.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osvos_tpu.configs import DataConfig as JaxDataConfig
from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.configs import OnlineConfig as JaxOnlineConfig
from osvos_tpu.configs import ParentConfig as JaxParentConfig
from osvos_tpu.data import davis as jax_davis
from osvos_tpu.data import synthetic as jax_synthetic
from osvos_tpu.train import online as jax_online
from osvos_tpu.train import parent as jax_parent
from osvos_torch.cli import train_parent as parent_cli
from osvos_torch.configs import (DataConfig, ModelConfig, OnlineConfig,
                                 ParentConfig)
from osvos_torch.data import davis, synthetic
from osvos_torch.models import init_osvos_params, params_to_jax
from osvos_torch.train import online, parent

H, W = 33, 49
N_FRAMES = 3
IMAGE_ATOL = 1e-3
GT_SHARE = 1e-3
TINY_STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{writer: root} of a synthetic tree from each package's generate."""
    out = {}
    for name, mod in (("port", synthetic), ("jax", jax_synthetic)):
        root = str(tmp_path_factory.mktemp(f"davis_{name}"))
        mod.generate(root, height=H, width=W, n_frames=N_FRAMES)
        out[name] = root
    return out


def _sets(root, **kw):
    """(port, JAX) datasets of the same arguments."""
    return (davis.DAVIS2016(db_root_dir=root, data_config=DataConfig(), **kw),
            jax_davis.DAVIS2016(db_root_dir=root, data_config=JaxDataConfig(),
                                **kw))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kw", [dict(train=True), dict(train=False),
                                dict(train=True, seq_name="synth-val-a"),
                                dict(train=False, seq_name="synth-val-b")],
                         ids=["train", "val", "one-shot", "sequence"])
def test_dataset_matches_jax(trees, writer, kw):
    ours, theirs = _sets(trees[writer], **kw)
    assert ours.img_list == theirs.img_list and len(ours) == len(theirs)
    assert ours.labels == theirs.labels
    assert ours.seqs_in_split == theirs.seqs_in_split
    assert ours.get_img_size() == theirs.get_img_size() == (H, W)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys() and got.get("fname") == want.get("fname")
        for k in ("image", "gt"):
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    if kw.get("seq_name") and not kw["train"]:
        assert not ours[1]["gt"].any() and ours[0]["gt"].any()


@pytest.mark.parametrize("size", [(40, 64), (20, 30)])
def test_dataset_input_res_matches_jax(trees, size):
    ours, theirs = _sets(trees["jax"], train=False, seq_name="synth-val-a",
                         input_res=size)
    img, gt = ours.make_img_gt_pair(0)
    want_img, want_gt = theirs.make_img_gt_pair(0)
    assert img.shape == want_img.shape == size + (3,)
    assert float(np.abs(img - want_img).max()) <= 1.0
    np.testing.assert_array_equal(gt, want_gt)


def test_split_files_fall_back_as_jax_does(tmp_path, trees):
    official = tmp_path / "ImageSets" / "2016"
    official.mkdir(parents=True)
    (official / "val.txt").write_text(
        "/JPEGImages/480p/bear/00000.jpg /Annotations/480p/bear/00000.png\n"
        "/JPEGImages/480p/bear/00001.jpg /Annotations/480p/bear/00001.png\n"
        "/JPEGImages/480p/cows/00000.jpg /Annotations/480p/cows/00000.png\n")
    for root, train in ((trees["port"], True), (str(tmp_path), False),
                        (str(tmp_path), True)):
        assert davis.read_split(root, train) == \
            jax_davis._read_split(root, train, "2016")
    assert davis.read_split(str(tmp_path), False) == ["bear", "cows"]
    assert len(davis.read_split(str(tmp_path), True)) == 30  # packaged copy
    with pytest.raises(FileNotFoundError):
        davis.read_split(str(tmp_path), True, year="2017")


def _pair(trees):
    ds = davis.DAVIS2016(train=True, db_root_dir=trees["jax"],
                         seq_name="synth-val-a")
    img, gt = ds.make_img_gt_pair(0)
    return img, gt[..., None]


def test_host_pool_matches_jax(trees):
    img, mask = _pair(trees)
    cfg = OnlineConfig()
    got = online.build_host_pool(img, mask, cfg, 6, seed=3)
    want = jax_online.build_host_pool(img, mask, JaxOnlineConfig(), 6, seed=3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
    np.testing.assert_array_equal(got[0][0], img)
    assert float(np.abs(got[0] - want[0]).max()) <= IMAGE_ATOL
    assert float((got[1] != want[1]).mean()) <= GT_SHARE
    assert not np.array_equal(got[0][1], got[0][2])


def _replay(keys, cfg, pool_size):
    """The JAX microbatch step's draws from ``keys`` as the port's Draws."""
    flips, index = [], []
    for key in keys:
        row_f, row_i = [], []
        for k in jax.random.split(key, cfg.n_ave_grad):
            ki, kf = jax.random.split(k)
            row_f.append(bool(jax.random.uniform(kf) < cfg.hflip_prob))
            row_i.append(int(jax.random.randint(ki, (), 0, pool_size)))
        flips.append(row_f)
        index.append(row_i)
    return online.Draws(flip=torch.tensor(flips), index=torch.tensor(index))


def test_run_online_pool_matches_jax(trees):
    """3 steps in chunks of 2 from the same parent, pool of 5 from seed 0."""
    img, mask = _pair(trees)
    mcfg = ModelConfig(stages=TINY_STAGES, side_channels=8,
                       compute_mode="parity")
    cfg = OnlineConfig(n_steps=3, n_ave_grad=2, lr=1e-5, scan_chunk=2)
    state0 = init_osvos_params(mcfg, torch.Generator().manual_seed(2))
    jcfg = JaxOnlineConfig(**dataclasses.asdict(cfg))
    want = jax_online.run_online(
        jax.tree.map(jnp.asarray, params_to_jax(state0)), img, mask,
        JaxModelConfig(**dataclasses.asdict(mcfg)), jcfg, pool_size=5)
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.n_steps)
    got = online.run_online(state0, img, mask, mcfg, cfg, pool_size=5,
                            device="cpu", draws=_replay(keys, cfg, 5))
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=2e-4)
    p0, pg = params_to_jax(state0), params_to_jax(got.params)
    pw = jax.tree.map(np.asarray, want.params)
    moved = 0.0
    for m in p0:
        for k in p0[m]:
            dg, dw = pg[m][k] - p0[m][k], pw[m][k] - p0[m][k]
            scale = float(np.abs(dw).max())
            moved = max(moved, scale)
            np.testing.assert_allclose(dg, dw, rtol=0,
                                       atol=max(5e-3 * scale, 1e-12),
                                       err_msg=f"delta of {m}.{k}")
    assert moved > 0


def test_parent_pipeline_from_db_root_matches_jax(trees):
    root = trees["jax"]
    cfg = ParentConfig(batch_size=2)
    ds = davis.DAVIS2016(train=True, db_root_dir=root)
    _, ours = parent.make_train_pipeline(ds, DataConfig(), cfg,
                                         input_res=(H, W), seed=5)
    _, theirs = jax_parent.make_train_pipeline(
        root, JaxDataConfig(), JaxParentConfig(batch_size=2),
        input_res=(H, W), seed=5)
    got, want = list(ours()), list(theirs())
    assert len(got) == len(want) == -(-2 * N_FRAMES // 2)
    for g, w in zip(got, want):
        assert g["image"].shape == w["image"].shape == (2, H, W, 3)
        assert float(np.abs(g["image"] - w["image"]).max()) <= IMAGE_ATOL
        assert float((g["gt"] != w["gt"]).mean()) <= GT_SHARE


def test_parent_cli_trains_from_db_root(trees, tmp_path, capsys):
    assert parent_cli.main([
        "--db_root", trees["port"], "--tiny", "--device", "cpu",
        "--epochs", "1", "--n_ave_grad", "2", "--test_interval", "1",
        "--input_h", str(H), "--input_w", str(W),
        "--save_root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[epoch 0]" in out and "val loss" in out
    assert os.path.exists(tmp_path / "models" / "parent_epoch-0.pt")
