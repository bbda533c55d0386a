"""One-shot online fine-tuning and sequence inference, the port's mirror of
``scripts/train_online.py``.

    python -m osvos_torch.cli.train_online --db_root /data/DAVIS \\
        --parent runs/models/parent_epoch-239.pt --seq_name blackswan
    python -m osvos_torch.cli.train_online --db_root /tmp/vd \\
        --parent /tmp/parent_tiny.pt --seq_name synth-val-a --tiny \\
        --device cpu --steps 2 --n_ave_grad 2 --eval

The same flags and defaults as the JAX package's script, plus ``--device``
(default: the card). ``--batched`` (the mesh-parallel fine-tune of every
val sequence) comes with ROADMAP.md A.5 and ``--infer_mode int8`` with A.6;
until then they raise.

Per sequence: the frames are decoded, the augmentation pool of frame 0 is warped on the host, the parent is
fine-tuned on the card (``train/online.run_online``), every frame is
inferred, and the probability maps are written as
``<save_root>/Results/<seq>/<frame>.png``, with the loss of every step in
``<log_dir>`` (default ``<save_root>/logs/<seq>``), the tuned weights in
``<save_root>/models/<seq>_online.pt``, overlays under
``<save_root>/Overlays/<seq>`` with ``--vis_res``, and ``J=`` / ``F=`` with
``--eval``. One line per phase gives its time; the summary line's
fine-tune time covers the pool build and the steps, as the JAX script's
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional

import numpy as np

TINY_STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db_root", default=None)
    ap.add_argument("--save_root", default=None)
    ap.add_argument("--parent", required=True,
                    help="parent checkpoint (.pt snapshot of the port, JAX "
                         ".ckpt, or a reference .pth/.npz state_dict)")
    ap.add_argument("--seq_name", default="blackswan")
    ap.add_argument("--all_val", action="store_true",
                    help="run every val-split sequence, one after another")
    ap.add_argument("--batched", action="store_true",
                    help="with --all_val: every sequence's fine-tune at once "
                         "over the devices (ROADMAP.md A.5)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n_ave_grad", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-8)
    ap.add_argument("--weight_decay", type=float, default=0.0002)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--compute_mode", default="flat",
                    choices=["fast", "parity", "flat"],
                    help="fine-tune compute mode; 'flat' runs the trunk's "
                         "forward and backward in the hand-written conv "
                         "kernels")
    ap.add_argument("--infer_mode", default=None,
                    choices=["fast", "parity", "int8"],
                    help="compute mode of the inference pass (default: "
                         "'fast' after a 'flat' fine-tune, else the same; "
                         "'int8' needs ROADMAP.md A.6)")
    ap.add_argument("--aug_mode", default="pool", choices=["pool", "per_step"])
    ap.add_argument("--loss_impl", default="xla", choices=["xla", "pallas"],
                    help="CB-BCE route of the fine-tune loss ('pallas': "
                         "the CUDA kernels)")
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--vis_res", action="store_true",
                    help="save mask-over-frame overlay PNGs under "
                         "<save_root>/Overlays/<seq>")
    ap.add_argument("--log_dir", default=None,
                    help="per-step fine-tune loss scalars (default: "
                         "<save_root>/logs/<seq>)")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced-width model (smoke tests and CPU runs; "
                         "its checkpoints do not fit the full model)")
    ap.add_argument("--eval", action="store_true",
                    help="compute DAVIS J/F for the sequence(s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of the fine-tune here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def load_annotations(ann_dir: str) -> List[np.ndarray]:
    """Ground-truth masks in {0, 1}, image files only (``.png``, ``.jpg``,
    ``.jpeg`` and ``.bmp``, as the JAX script takes them). As the JAX script
    skips what ``cv2.imread`` cannot read, a file that is neither JPEG, PNG
    nor BMP, or is truncated or corrupt, is skipped; a valid image this
    reader does not decode (a progressive JPEG, an RLE BMP) raises, since
    skipping it would shift J/F."""
    from osvos_torch.data.image_io import UnsupportedImage, imread

    anns = []
    for f in sorted(os.listdir(ann_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        try:
            a = imread(os.path.join(ann_dir, f), gray=True)
        except UnsupportedImage:
            raise
        except ValueError:  # cv2.imread gives None
            continue
        anns.append(a / max(a.max(), 1e-8))
    return anns


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.batched:
        raise NotImplementedError("--batched (the mesh-parallel fine-tune of "
                                  "all sequences) comes with ROADMAP.md A.5")
    if args.infer_mode == "int8":
        raise NotImplementedError("--infer_mode int8 comes with ROADMAP.md A.6")

    import torch

    from osvos_torch.configs import (DataConfig, ModelConfig, OnlineConfig,
                                     PathConfig)
    from osvos_torch.data.davis import DAVIS2016, read_split
    from osvos_torch.data.helpers import overlay_mask
    from osvos_torch.data.image_io import write_png_rgb
    from osvos_torch.evaluation.davis_j import evaluate_sequence
    from osvos_torch.evaluation.infer import (infer_sequence,
                                              save_sequence_results)
    from osvos_torch.models import OSVOS
    from osvos_torch.train.online import (build_host_pool, resolve_device,
                                          run_online)
    from osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from osvos_torch.utils.logging import ScalarLogger
    from osvos_torch.utils.profiling import PhaseTimer, annotate, device_trace

    device = resolve_device(args.device)
    paths = PathConfig()
    db_root = args.db_root or paths.db_root_dir
    save_root = args.save_root or paths.save_root_dir
    results_dir = os.path.join(save_root, "Results")
    stages = TINY_STAGES if args.tiny else ModelConfig().stages
    model_config = ModelConfig(stages=stages,
                               side_channels=8 if args.tiny else 16,
                               compute_mode=args.compute_mode)
    cfg = OnlineConfig(seq_name=args.seq_name, n_steps=args.steps,
                       n_ave_grad=args.n_ave_grad, lr=args.lr,
                       weight_decay=args.weight_decay, momentum=args.momentum,
                       seed=args.seed, loss_impl=args.loss_impl,
                       save_results=not args.no_save, vis_res=args.vis_res)
    params = load_checkpoint(args.parent, model_config)
    data_cfg = DataConfig()
    # inference defaults to 'fast' after a 'flat' fine-tune: the flat
    # kernels are the training trunk, the fused head the inference path
    infer_mode = args.infer_mode or (
        "fast" if args.compute_mode == "flat" else args.compute_mode)
    infer_config = dataclasses.replace(model_config, compute_mode=infer_mode)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run_one(seq: str) -> Optional[Dict[str, float]]:
        ocfg = dataclasses.replace(cfg, seq_name=seq)
        timer = PhaseTimer()
        test_ds = DAVIS2016(train=False, db_root_dir=db_root, seq_name=seq,
                            data_config=data_cfg)
        with timer.phase("decode"):
            pairs = [test_ds.make_img_gt_pair(i) for i in range(len(test_ds))]
        frames = [p[0] for p in pairs]
        img, gt = pairs[0]  # the one-shot pair: frame 0 and its annotation
        pool = None
        if args.aug_mode == "pool":
            with timer.phase("pool build"):
                pool = build_host_pool(img, gt[..., None], ocfg, 100,
                                       seed=ocfg.seed)
        with timer.phase("fine-tune steps"), \
                device_trace(args.profile_dir), annotate(f"fine_tune/{seq}"):
            result = run_online(params, img, gt[..., None], model_config,
                                ocfg, aug_mode=args.aug_mode, device=device,
                                pool=pool)
            losses = result.losses.cpu().numpy()
            sync()

        log_dir = args.log_dir or os.path.join(save_root, "logs", seq)
        logger = ScalarLogger(log_dir)
        for step, loss in enumerate(losses):
            logger.add_scalar("total_loss_epoch", float(loss), step)
        logger.close()

        model = OSVOS(infer_config)
        model.load_state_dict(result.params)
        model.to(device).eval()
        with timer.phase("inference"):
            masks = infer_sequence(model, frames)
            sync()
        fnames = test_ds.img_list
        with timer.phase("PNG writes"):
            if ocfg.vis_res:
                mean = np.asarray(data_cfg.meanval, np.float32)
                for frame, mask, fname in zip(frames, masks, fnames):
                    bgr = np.clip(frame + mean, 0, 255).astype(np.uint8)
                    stem = os.path.splitext(os.path.basename(fname))[0]
                    write_png_rgb(os.path.join(save_root, "Overlays", seq,
                                               f"{stem}.png"),
                                  overlay_mask(bgr, mask >= 128)[..., ::-1])
            if ocfg.save_results:
                save_sequence_results(masks, fnames, results_dir, seq)
                save_checkpoint(os.path.join(save_root, "models",
                                             f"{seq}_online.pt"),
                                result.params, step=ocfg.n_steps)
        t = timer.totals
        fine_tune_s = t.get("pool build", 0.0) + t["fine-tune steps"]
        print(f"[{seq}] fine-tune {fine_tune_s:.1f}s ({ocfg.n_steps} "
              f"steps), inference [{infer_mode}] "
              f"{len(frames) / max(t['inference'], 1e-9):.1f} f/s, final "
              f"loss {float(losses[-1]):.4f}", flush=True)
        metrics = None
        if args.eval:
            with timer.phase("eval"):
                ann_dir = os.path.join(db_root, "Annotations",
                                       data_cfg.resolution, seq)
                anns = load_annotations(ann_dir)
                if len(anns) == len(masks):
                    metrics = evaluate_sequence(anns, [m >= 128 for m in masks])
            if metrics is not None:
                print(f"[{seq}] J={metrics['J_mean']:.4f} "
                      f"F={metrics['F_mean']:.4f}", flush=True)
            else:
                print(f"[{seq}] WARNING: skipping J/F: {len(anns)} "
                      f"annotations in {ann_dir} vs {len(masks)} predicted "
                      "masks (mismatched directory?)", flush=True)
        step_ms = 1e3 * t["fine-tune steps"] / ocfg.n_steps
        per = {"decode": f"{len(frames)} frames, "
                         f"{t['decode'] / len(frames):.4f} s/frame",
               "fine-tune steps": f"{step_ms:.2f} ms/step",
               "inference": f"{len(frames) / max(t['inference'], 1e-9):.2f} "
                            "frames/s"}
        for name, secs in timer.totals.items():
            note = f" ({per[name]})" if name in per else ""
            print(f"[{seq}] time {name}: {secs:.3f} s{note}", flush=True)
        return metrics

    if args.all_val:
        metrics = [m for m in (run_one(seq) for seq in
                               read_split(db_root, False, data_cfg.year)) if m]
        if metrics:
            print(f"[ALL] J-mean={np.mean([m['J_mean'] for m in metrics]):.4f} "
                  f"F-mean={np.mean([m['F_mean'] for m in metrics]):.4f}",
                  flush=True)
    else:
        run_one(args.seq_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
