"""The port's online CLI (``osvos_torch/cli/train_online.py``) on the CPU.

It runs ``--tiny --device cpu`` for 2 steps with ``--eval --vis_res
--all_val`` on a synthetic DAVIS tree and must leave the layout that
``scripts/train_online.py`` writes: ``Results/<seq>/<frame>.png`` and
``Overlays/<seq>/<frame>.png`` per frame, ``logs/<seq>/scalars.jsonl`` with
one record per step, the ``models/<seq>_online`` checkpoint, and ``J=`` /
``F=`` lines equal (to the printed 4 decimals) to the JAX package's
``evaluate_sequence`` on the written PNGs, read back by OpenCV.
"""

import contextlib
import io
import json
import os
import re

import cv2
import numpy as np
import pytest
import torch

from osvos_tpu.evaluation.davis_j import evaluate_sequence as jax_evaluate
from osvos_torch.cli import train_online as cli
from osvos_torch.configs import ModelConfig
from osvos_torch.data import image_io
from osvos_torch.data.synthetic import DEFAULT_VAL_SEQS, generate
from osvos_torch.models import OSVOS, init_osvos_params
from osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint

H, W, N_FRAMES, STEPS = 33, 49, 3, 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(save_root, db_root, stdout) of one CLI run over the val split."""
    tmp = tmp_path_factory.mktemp("cli_online")
    db_root = generate(str(tmp / "davis"), height=H, width=W, n_frames=N_FRAMES)
    cfg = ModelConfig(stages=cli.TINY_STAGES, side_channels=8)
    parent = save_checkpoint(str(tmp / "parent.pt"),
                             init_osvos_params(cfg, torch.Generator().manual_seed(0)),
                             step=0)
    save_root = tmp / "runs"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--db_root", db_root, "--parent", parent, "--tiny",
                         "--device", "cpu", "--steps", str(STEPS),
                         "--n_ave_grad", "2", "--eval", "--vis_res",
                         "--all_val", "--save_root", str(save_root)]) == 0
    return save_root, db_root, out.getvalue()


def test_cli_writes_the_jax_scripts_layout(run):
    save_root, _, out = run
    for seq in DEFAULT_VAL_SEQS:
        for kind in ("Results", "Overlays"):
            names = sorted(os.listdir(save_root / kind / seq))
            assert names == [f"{i:05d}.png" for i in range(N_FRAMES)], kind
        pred = cv2.imread(str(save_root / "Results" / seq / "00000.png"), 0)
        overlay = cv2.imread(str(save_root / "Overlays" / seq / "00000.png"))
        assert pred.shape == (H, W) and overlay.shape == (H, W, 3)
        with open(save_root / "logs" / seq / "scalars.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert [r["step"] for r in records] == list(range(STEPS))
        assert all(r["tag"] == "total_loss_epoch" for r in records)
        tuned = load_checkpoint(str(save_root / "models" / f"{seq}_online.pt"),
                                ModelConfig(stages=cli.TINY_STAGES, side_channels=8))
        assert set(tuned) == set(OSVOS(ModelConfig(stages=cli.TINY_STAGES,
                                                   side_channels=8)).state_dict())
        assert re.search(rf"\[{seq}\] fine-tune .* \({STEPS} steps\), "
                         r"inference \[fast\]", out)
        for phase in ("decode", "pool build", "fine-tune steps", "inference",
                      "PNG writes", "eval"):
            assert re.search(rf"\[{seq}\] time {phase}: [0-9.]+ s", out), phase
    assert "[ALL] J-mean=" in out


def test_cli_scores_equal_the_jax_evaluation(run):
    save_root, db_root, out = run
    js, fs = [], []
    for seq in DEFAULT_VAL_SEQS:
        ann_dir = os.path.join(db_root, "Annotations", "480p", seq)
        anns = [cv2.imread(os.path.join(ann_dir, f), 0) / 255.0
                for f in sorted(os.listdir(ann_dir))]
        preds = [cv2.imread(str(save_root / "Results" / seq / f"{i:05d}.png"), 0)
                 >= 128 for i in range(N_FRAMES)]
        m = jax_evaluate(anns, preds)
        assert f"[{seq}] J={m['J_mean']:.4f} F={m['F_mean']:.4f}" in out
        js.append(m["J_mean"])
        fs.append(m["F_mean"])
    assert f"[ALL] J-mean={np.mean(js):.4f} F-mean={np.mean(fs):.4f}" in out


def test_cli_skips_a_stray_annotation_file_and_still_scores(tmp_path):
    """A stray ``notes.png`` of text and a truncated mask beside the masks
    are skipped, as the JAX script's ``cv2.imread`` skips them (it returns
    None for both): the masks load and the eval runs. A valid image the
    reader does not decode (a progressive JPEG) raises instead."""
    seq = DEFAULT_VAL_SEQS[0]
    db_root = generate(str(tmp_path / "davis"), height=H, width=W, n_frames=2,
                       train_seqs=[], val_seqs=[seq])
    ann_dir = os.path.join(db_root, "Annotations", "480p", seq)
    masks = [cv2.imread(os.path.join(ann_dir, f), 0)
             for f in sorted(os.listdir(ann_dir))]
    with open(os.path.join(ann_dir, "00000.png"), "rb") as f:
        cut = f.read()[:60]
    with open(os.path.join(ann_dir, "notes.png"), "wb") as f:
        f.write(b"frame 1: the object leaves the view\n")
    with open(os.path.join(ann_dir, "zz_cut.png"), "wb") as f:
        f.write(cut)
    for stray in ("notes.png", "zz_cut.png"):
        assert cv2.imread(os.path.join(ann_dir, stray), 0) is None
    anns = cli.load_annotations(ann_dir)
    assert len(anns) == len(masks) == 2
    for got, m in zip(anns, masks):
        np.testing.assert_array_equal(got, m / max(m.max(), 1e-8))

    cfg = ModelConfig(stages=cli.TINY_STAGES, side_channels=8)
    parent = save_checkpoint(str(tmp_path / "parent.pt"),
                             init_osvos_params(cfg, torch.Generator().manual_seed(0)),
                             step=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--db_root", db_root, "--parent", parent, "--tiny",
                         "--device", "cpu", "--seq_name", seq, "--steps", "1",
                         "--n_ave_grad", "1", "--eval",
                         "--save_root", str(tmp_path / "runs")]) == 0
    assert re.search(rf"\[{seq}\] J=[0-9.]+ F=[0-9.]+", out.getvalue())

    ok, buf = cv2.imencode(".jpg", np.zeros((H, W), np.uint8),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with open(os.path.join(ann_dir, "00002.jpg"), "wb") as f:
        f.write(buf.tobytes())
    with pytest.raises(image_io.UnsupportedImage, match="progressive"):
        cli.load_annotations(ann_dir)


def test_cli_reads_and_scores_bmp_annotations(tmp_path):
    """Annotations written as ``.bmp`` (OpenCV's writer, the same masks), as
    the JAX script's ``cv2.imread`` reads them: ``load_annotations`` gives
    the masks of the PNGs, and the CLI tunes on frame 0's ``.bmp`` and
    scores the same J and F as from the PNGs."""
    seq = DEFAULT_VAL_SEQS[0]
    db_root = generate(str(tmp_path / "davis"), height=H, width=W, n_frames=2,
                       train_seqs=[], val_seqs=[seq])
    ann_dir = os.path.join(db_root, "Annotations", "480p", seq)
    cfg = ModelConfig(stages=cli.TINY_STAGES, side_channels=8)
    parent = save_checkpoint(str(tmp_path / "parent.pt"),
                             init_osvos_params(cfg, torch.Generator().manual_seed(0)),
                             step=0)

    def score():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["--db_root", db_root, "--parent", parent, "--tiny",
                             "--device", "cpu", "--seq_name", seq, "--steps", "1",
                             "--n_ave_grad", "1", "--eval",
                             "--save_root", str(tmp_path / "runs")]) == 0
        found = re.search(rf"\[{seq}\] J=([0-9.]+) F=([0-9.]+)", out.getvalue())
        assert found
        return found.groups()

    from_png = cli.load_annotations(ann_dir)
    want = score()
    for f in sorted(os.listdir(ann_dir)):
        path = os.path.join(ann_dir, f)
        assert cv2.imwrite(path[:-4] + ".bmp", cv2.imread(path, 0))
        os.remove(path)
    assert all(f.endswith(".bmp") for f in os.listdir(ann_dir))
    from_bmp = cli.load_annotations(ann_dir)
    assert len(from_bmp) == len(from_png) == 2
    for got, m in zip(from_bmp, from_png):
        np.testing.assert_array_equal(got, m)
    assert score() == want


@pytest.mark.parametrize("extra,where", [(["--all_val", "--batched"], "A.5"),
                                         (["--infer_mode", "int8"], "A.6")])
def test_cli_refuses_what_is_not_ported(extra, where):
    with pytest.raises(NotImplementedError, match=where):
        cli.main(["--parent", "p.pt", "--device", "cpu"] + extra)
