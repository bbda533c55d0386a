"""One-shot online fine-tuning and sequence inference, the port's mirror of
``scripts/train_online.py``.

    python -m osvos_torch.cli.train_online --db_root /data/DAVIS \\
        --parent runs/models/parent_epoch-239.pt --seq_name blackswan
    python -m osvos_torch.cli.train_online --db_root /tmp/vd \\
        --parent /tmp/parent_tiny.pt --seq_name synth-val-a --tiny \\
        --device cpu --steps 2 --n_ave_grad 2 --eval

The same flags and defaults as the JAX package's script, plus ``--device``
(default: the card). ``--all_val --batched`` fine-tunes every val sequence
in one call (``parallel/batched_online.batched_fine_tune`` over a ``'seq'``
mesh when the process group has more than one rank, e.g. under
``OSVOS_MULTIHOST=1 torchrun --nproc_per_node N``; by the JAX package's
rule the rounds schedule on a mesh or in flat mode, else the packed
schedule: all the sequences as one grouped-conv model), then infers them
all (``batched_infer``) and writes the PNGs and J/F as the JAX script's
``run_batched`` does. ``--infer_mode int8`` calibrates static activation scales on the tuned
weights and frame 0 (``models/quantize.py``), then infers through the
int8 trunk.

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
                    help="with --all_val: every sequence fine-tuned in one "
                         "call")
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
                         "'int8' calibrates static activation scales on the "
                         "tuned weights and frame 0)")
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
                    help="write a torch.profiler trace of each sequence's "
                         "phases here (not with --batched)")
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


def run_batched(args: argparse.Namespace, seqs: List[str], params,
                model_config, cfg, infer_mode: str, data_cfg, db_root: str,
                results_dir: str, device) -> None:
    """All sequences fine-tuned in one call, then inferred together (the
    JAX script's ``run_batched``, BASELINE config 5). Every frame takes the
    first sequence's size (``data/transforms.resize``: bilinear frames,
    nearest masks). Only the mesh's first rank writes and scores."""
    from osvos_torch.data.davis import DAVIS2016
    from osvos_torch.data.transforms import resize
    from osvos_torch.evaluation.davis_j import evaluate_sequence
    from osvos_torch.evaluation.infer import save_mask_png
    from osvos_torch.models.quantize import calibrate_int8_scales_batched
    from osvos_torch.parallel.batched_online import (batched_fine_tune,
                                                     batched_infer)
    from osvos_torch.parallel.mesh import make_mesh, mesh_rank, world_size
    from osvos_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    hw = None
    first_imgs, first_masks, frame_lists, name_lists = [], [], [], []
    with timer.phase("decode"):
        for seq in seqs:
            ds = DAVIS2016(train=False, db_root_dir=db_root, seq_name=seq,
                           data_config=data_cfg)
            pairs = [ds.make_img_gt_pair(i) for i in range(len(ds))]
            img, gt = pairs[0]
            hw = hw or img.shape[:2]
            if img.shape[:2] != hw:
                gt = resize(gt, hw, nearest=True)
            frames = [f if f.shape[:2] == hw
                      else resize(f, hw, nearest=False, bilinear=True)
                      for f, _ in pairs]
            first_imgs.append(frames[0])
            first_masks.append(gt[..., None])
            frame_lists.append(frames)
            name_lists.append(list(ds.img_list))
    images, masks = np.stack(first_imgs), np.stack(first_masks)

    mesh = make_mesh("seq", device_type=device.type) if world_size() > 1 \
        else None
    main_rank = mesh_rank(mesh) == 0
    with timer.phase("fine-tune", sync=True):
        adapted, losses = batched_fine_tune(params, images, masks,
                                            model_config, cfg, mesh=mesh,
                                            aug_mode=args.aug_mode,
                                            device=device)
        losses = losses.cpu().numpy()
    ft = timer.totals["fine-tune"]
    if main_rank:
        print(f"[batched] {len(seqs)} sequences fine-tuned in {ft:.1f}s "
              f"({ft / len(seqs):.1f}s/seq amortized), final losses "
              f"{[round(float(x), 4) for x in losses[:, -1]]}", flush=True)

    icfg = dataclasses.replace(model_config, compute_mode=infer_mode,
                               int8_scales=None)
    act_scales = None
    if infer_mode == "int8":
        with timer.phase("int8 calibration", sync=True):
            act_scales = calibrate_int8_scales_batched(adapted, images, icfg)
    with timer.phase("inference"):
        # ragged lists: batched_infer pads and chunks the frame axis under
        # its memory budget instead of one (S, T, H, W, 3) stack
        maps = batched_infer(adapted, frame_lists, icfg, mesh=mesh,
                             act_scales=act_scales, device=device)
    n_frames = sum(len(f) for f in frame_lists)
    if main_rank:
        with timer.phase("PNG writes"):
            if not args.no_save:
                for si, seq in enumerate(seqs):
                    for ti, fname in enumerate(name_lists[si]):
                        stem = os.path.splitext(os.path.basename(fname))[0]
                        save_mask_png(maps[si, ti], os.path.join(
                            results_dir, seq, f"{stem}.png"))
        if args.eval:
            js, fs = [], []
            with timer.phase("eval"):
                for si, seq in enumerate(seqs):
                    ann_dir = os.path.join(db_root, "Annotations",
                                           data_cfg.resolution, seq)
                    anns = load_annotations(ann_dir)
                    n = len(name_lists[si])
                    if len(anns) < n:
                        # the serial path's warn-and-skip: one mismatched
                        # directory must not end the whole evaluation
                        print(f"[{seq}] WARNING: skipping J/F: {len(anns)} "
                              f"annotations in {ann_dir} vs {n} predicted "
                              "masks (mismatched directory?)", flush=True)
                        continue
                    m = evaluate_sequence(anns[:n],
                                          [maps[si, t] >= 128 for t in range(n)])
                    print(f"[{seq}] J={m['J_mean']:.4f} F={m['F_mean']:.4f}",
                          flush=True)
                    js.append(m["J_mean"])
                    fs.append(m["F_mean"])
            if js:
                print(f"[ALL] J-mean={np.mean(js):.4f} "
                      f"F-mean={np.mean(fs):.4f}", flush=True)
        per = {"decode": f"{n_frames} frames",
               "fine-tune": f"{len(seqs)} sequences, {cfg.n_steps} steps each",
               "inference": f"[{infer_mode}] "
                            f"{n_frames / max(timer.totals['inference'], 1e-9):.2f} "
                            "frames/s"}
        for name, secs in timer.totals.items():
            note = f" ({per[name]})" if name in per else ""
            print(f"[batched] time {name}: {secs:.3f} s{note}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)

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
    from osvos_torch.models.quantize import calibrate_int8_scales
    from osvos_torch.parallel.mesh import initialize_multihost
    from osvos_torch.train.online import (build_host_pool, resolve_device,
                                          run_online)
    from osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from osvos_torch.utils.logging import ScalarLogger
    from osvos_torch.utils.profiling import PhaseTimer, device_trace, span

    started = initialize_multihost()
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
        # a sequence's trace holds each of its phases as a span
        with device_trace(args.profile_dir):
            return run_phases(seq)

    def run_phases(seq: str) -> Optional[Dict[str, float]]:
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
        with timer.phase("fine-tune steps"), span(f"fine_tune/{seq}"):
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

        icfg = infer_config
        if infer_mode == "int8":
            with timer.phase("int8 calibration"):
                scales = calibrate_int8_scales(result.params, frames[0][None],
                                               icfg)
            icfg = dataclasses.replace(icfg, int8_scales=scales)
        model = OSVOS(icfg)
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

    if args.all_val and args.batched:
        run_batched(args, read_split(db_root, False, data_cfg.year), params,
                    model_config, cfg, infer_mode, data_cfg, db_root,
                    results_dir, device)
    elif args.all_val:
        metrics = [m for m in (run_one(seq) for seq in
                               read_split(db_root, False, data_cfg.year)) if m]
        if metrics:
            print(f"[ALL] J-mean={np.mean([m['J_mean'] for m in metrics]):.4f} "
                  f"F-mean={np.mean([m['F_mean'] for m in metrics]):.4f}",
                  flush=True)
    else:
        run_one(args.seq_name)
    if started:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
