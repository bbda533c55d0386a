"""Parent-network training, the port's mirror of ``scripts/train_parent.py``.

    python -m osvos_torch.cli.train_parent --db_root /data/DAVIS --epochs 240
    python -m osvos_torch.cli.train_parent --synthetic 64 --epochs 4
    python -m osvos_torch.cli.train_parent --synthetic 8 --tiny --device cpu \\
        --epochs 2 --n_ave_grad 2 --test_interval 1 --snapshot 2 \\
        --input_h 96 --input_w 160

The same flags and defaults as the JAX package's script, plus
``--synthetic N`` (train on N in-memory synthetic frames, and probe on a
val split of N // 4, instead of the DAVIS tree at ``--db_root``) and
``--device`` (default: the card). ``--vis_net`` draws the autograd graph of
one train-mode forward of the trainer's model in ``--compute_mode``, on
zeros of the JAX script's shape (1, 64, 112, 3) on the device, to
``<save_root>/net.dot`` (``utils/visualize.make_dot``; a PDF beside it where
the ``dot`` binary is on PATH), before training; the draw leaves training as
it would be without.

``--data_parallel N`` trains over a 1-D ``'data'`` mesh of N ranks, one
process a device: on a machine with N cards,
``OSVOS_MULTIHOST=1 torchrun --nproc_per_node N -m
osvos_torch.cli.train_parent --data_parallel N ...`` (NCCL; gloo with
``--device cpu``). Every rank draws the same global batches and trains on
its share (``train/parent.py``); only the first rank prints, logs and
writes snapshots. With fewer ranks than N it raises.

Each epoch prints its mean loss; every ``--test_interval`` epochs the val
loss; every ``--snapshot`` epochs, and after the last, a snapshot with the
optimizer state (``<save_root>/models/parent_epoch-<e>.pt``), which
``--resume`` continues after. ``--resume`` also takes the JAX package's
``.ckpt`` snapshots.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

TINY_STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db_root", default=None,
                    help="DAVIS root (default: PathConfig().db_root_dir)")
    ap.add_argument("--save_root", default=None)
    ap.add_argument("--epochs", type=int, default=240)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--n_ave_grad", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-8)
    ap.add_argument("--weight_decay", type=float, default=0.0002)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--snapshot", type=int, default=40)
    ap.add_argument("--test_interval", type=int, default=5)
    ap.add_argument("--no_test", action="store_true")
    ap.add_argument("--resume", default=None,
                    help="snapshot to continue after (.pt, or a JAX .ckpt)")
    ap.add_argument("--vgg_npz", default=None,
                    help="torchvision VGG-16 weights as .npz/.pth for the "
                         "ImageNet trunk init")
    ap.add_argument("--compute_mode", default="fast",
                    choices=["fast", "parity", "flat"])
    ap.add_argument("--loss_impl", default="xla", choices=["xla", "pallas"],
                    help="CB-BCE route of the training loss "
                         "(ParentConfig.loss_impl)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="ranks of batch-parallel training, one process a "
                         "device (0 or 1: one device, no process group)")
    ap.add_argument("--input_h", type=int, default=480)
    ap.add_argument("--input_w", type=int, default=854)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced-width model (smoke tests and CPU runs; "
                         "its checkpoints do not fit the full model)")
    ap.add_argument("--vis_net", action="store_true",
                    help="write the autograd graph of one forward at "
                         "1x64x112 to <save_root>/net.dot (and net.pdf "
                         "where graphviz's dot is on PATH) before training")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="train on N in-memory synthetic frames instead of "
                         "DAVIS")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)

    from osvos_torch.configs import (DataConfig, ModelConfig, ParentConfig,
                                     PathConfig)
    from osvos_torch.data.davis import DAVIS2016
    from osvos_torch.data.synthetic import SyntheticDAVIS
    from osvos_torch.data.transforms import Compose, Resize, ToArray
    from osvos_torch.models import init_osvos_params
    from osvos_torch.parallel.mesh import (initialize_multihost, make_mesh,
                                           mesh_rank)
    from osvos_torch.train.online import resolve_device
    from osvos_torch.train.parent import ParentTrainer, make_train_pipeline
    from osvos_torch.utils.checkpoint import (load_training_state,
                                              save_checkpoint)
    from osvos_torch.utils.logging import ScalarLogger, StepTimer

    started = initialize_multihost()
    device = resolve_device(args.device)
    mesh = (make_mesh("data", args.data_parallel, device.type)
            if args.data_parallel > 1 else None)
    main_rank = mesh_rank(mesh) == 0
    say = print if main_rank else (lambda *a, **k: None)
    paths = PathConfig()
    db_root = args.db_root or paths.db_root_dir
    save_root = args.save_root or paths.save_root_dir
    if main_rank:
        os.makedirs(save_root, exist_ok=True)
    cfg = ParentConfig(
        n_epochs=args.epochs, batch_size=args.batch_size,
        n_ave_grad=args.n_ave_grad, snapshot_every=args.snapshot,
        lr=args.lr, weight_decay=args.weight_decay, momentum=args.momentum,
        use_test=not args.no_test, test_interval=args.test_interval,
        loss_impl=args.loss_impl, seed=args.seed)
    if args.tiny:
        model_config = ModelConfig(stages=TINY_STAGES, side_channels=8,
                                   compute_mode=args.compute_mode)
    else:
        model_config = ModelConfig(compute_mode=args.compute_mode)

    trunk = _load_vgg_features(args.vgg_npz) if args.vgg_npz else None
    params = init_osvos_params(model_config,
                               torch.Generator().manual_seed(args.seed),
                               trunk_weights=trunk)
    trainer = ParentTrainer(params, model_config, cfg, device=device,
                            mesh=mesh)

    start_epoch = 0
    if args.resume:
        params, opt_state, last = load_training_state(args.resume)
        trainer.load(params, opt_state)
        start_epoch = last + 1
        say(f"resumed from {args.resume} after epoch {last}", flush=True)
    if args.vis_net and main_rank:
        # one forward of the trainer's own model, no backward: training is
        # as it would be without the flag
        from osvos_torch.utils.visualize import make_dot, save_dot
        dot = make_dot(trainer.model, torch.zeros(1, 64, 112, 3,
                                                  device=trainer.device))
        print("net graph ->", save_dot(dot, os.path.join(save_root,
                                                         "net.dot")),
              flush=True)

    size = (args.input_h, args.input_w)
    data_cfg = DataConfig()
    if args.synthetic:
        train_ds = SyntheticDAVIS(args.synthetic, size, train=True,
                                  seed=args.seed)
    else:
        train_ds = DAVIS2016(train=True, db_root_dir=db_root,
                             data_config=data_cfg)
    _, epoch_batches = make_train_pipeline(train_ds, data_cfg, cfg,
                                           input_res=size, seed=args.seed)
    val_ds = None
    if cfg.use_test:
        val_tf = Compose([Resize(size), ToArray()])
        val_ds = (SyntheticDAVIS(max(1, args.synthetic // 4), size,
                                 train=False, transform=val_tf, seed=args.seed)
                  if args.synthetic else
                  DAVIS2016(train=False, db_root_dir=db_root, transform=val_tf,
                            data_config=data_cfg))

    logger = ScalarLogger(os.path.join(save_root, "logs_parent")) \
        if main_rank else None
    timer = StepTimer()
    step = 0
    for epoch in range(start_epoch, cfg.n_epochs):
        side_w = 1.0 - epoch / cfg.n_epochs
        epoch_loss = []
        for batch in epoch_batches():
            metrics = trainer.train_step(batch["image"], batch["gt"], side_w)
            step += 1
            epoch_loss.append(float(metrics["total"]))
            if logger is not None and step % cfg.log_every_steps == 0:
                logger.add_scalar("total_loss_iter", epoch_loss[-1], step)
        if logger is not None:
            logger.add_scalar("total_loss_epoch", float(np.mean(epoch_loss)),
                              epoch)
        say(f"[epoch {epoch}] loss={np.mean(epoch_loss):.4f} "
            f"elapsed={timer.elapsed():.1f}s", flush=True)
        if main_rank and val_ds is not None \
                and (epoch + 1) % cfg.test_interval == 0:
            stride = max(1, len(val_ds) // 64)  # probe subset, loss only
            val_losses = []
            for i in range(0, len(val_ds), stride):
                s = val_ds[i]
                val_losses.append(trainer.val_loss(s["image"][None],
                                                   s["gt"][None]))
            logger.add_scalar("val_loss_epoch", float(np.mean(val_losses)),
                              epoch)
            print(f"  val loss={np.mean(val_losses):.4f}", flush=True)
        if main_rank and ((epoch + 1) % cfg.snapshot_every == 0
                          or epoch == cfg.n_epochs - 1):
            ckpt = os.path.join(save_root, "models", f"parent_epoch-{epoch}.pt")
            save_checkpoint(ckpt, trainer.params, trainer.opt_state, epoch)
            print(f"  snapshot -> {ckpt}", flush=True)
    if logger is not None:
        logger.close()
    if started:
        torch.distributed.destroy_process_group()
    return 0


def _load_vgg_features(path: str):
    """A torchvision VGG-16 state (``features.<idx>.*``) from .npz or .pth."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state.get("state_dict", state)


if __name__ == "__main__":
    sys.exit(main())
