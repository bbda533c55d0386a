"""The packed schedule on one card, as ``--all_val --batched
--compute_mode fast`` runs it there (``parallel/batched_online.
_fine_tune_packed``): one ``PackedOSVOS`` over the S sequences, every
sequence starting from the same parent, its bf16 pool staged on the card
once, ``make_packed_chunk_fn``'s chunk of ``chunk_steps`` steps a call, a
synchronize only between calls.

Traffic parameters: ``sequences`` (S), ``pool`` (entries a sequence, as
``batched_online.pool_cap`` caps them for S on one card), ``chunk_steps``,
``checked_steps``, ``checked_sequences`` (how many sequences, drawn from the
seed, the reference follows), ``warm_steps``, ``draw_chunks``,
``profile_steps``, ``gap_steps``. One unit of work is a sequence's
optimizer step: a packed step is S of them.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from benchmark.lib import counts, inputs, training
from benchmark.reference import compare


class Job:
    kind = "finetune"

    def __init__(self, ctx):
        from osvos_torch.parallel.packed import (PackedOSVOS, draws_steps,
                                                 make_packed_chunk_fn)
        from osvos_torch.train.online import Draws, make_online_optimizer

        cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.draws_steps = draws_steps
        h, w = cfg["input_hw"]
        o = cfg["online"]
        n, pool, s = o["n_ave_grad"], tr["pool"], tr["sequences"]
        self.s, self.steps_per_chunk = s, tr["chunk_steps"]
        self.info = {"sequences": s, "batch": n, "h": h, "w": w,
                     "stages": cfg["stages"],
                     "side_channels": cfg["side_channels"],
                     "flops_per_step": counts.step_flops(
                         cfg["stages"], cfg["side_channels"], n, h, w)}

        # the benchmark's inputs: one parent, S first frames and masks, a
        # bf16 pool a sequence, each sequence's draws
        self.p0 = inputs.make_params(cfg["stages"], cfg["side_channels"], seed, dev)
        frames = inputs.make_frames(s, h, w, seed, dev)
        masks = inputs.make_masks(s, h, w, seed, dev)
        self.pool_imgs = torch.empty((s, pool, h, w, 3), dtype=torch.bfloat16, device=dev)
        self.pool_masks = torch.empty((s, pool, h, w, 1), dtype=torch.bfloat16, device=dev)
        for i in range(s):
            imgs, msks = inputs.warp_pool(frames[i], masks[i], pool, seed,
                                          o["rots"], o["scales"], f"pool{i}")
            self.pool_imgs[i].copy_(imgs)
            self.pool_masks[i].copy_(msks)
            del imgs, msks
        del frames, masks
        k = tr["checked_steps"]
        first = torch.stack([inputs.first_rows(k, n, pool, seed, dev, f"first{i}")
                             for i in range(s)])
        _, first_flip = inputs.random_rows(s * k, n, pool, seed, dev, "first_flip")
        steps = self.steps_per_chunk * tr["draw_chunks"]
        index, flip = inputs.random_rows(s * steps, n, pool, seed, dev, "draws")
        self.first = Draws(flip=first_flip.view(s, k, n), index=first)
        self.draws = Draws(flip=flip.view(s, steps, n), index=index.view(s, steps, n))
        gen = inputs.generator(seed, "checked", "cpu")
        self.checked = sorted(torch.randperm(s, generator=gen)[:tr["checked_sequences"]].tolist())
        self.batches = {i: [training.sample_batch(self.pool_imgs[i], self.pool_masks[i],
                                                  first[i, t], self.first.flip[i, t])
                            for t in range(k)] for i in self.checked}

        # the program's objects, built once and handed to the window
        mcfg, ocfg = training.model_config(cfg), training.online_config(cfg)
        stacked = {k_: v[None].expand((s,) + v.shape).contiguous()
                   for k_, v in self.p0.items()}
        self.model = PackedOSVOS(mcfg, s).to(dev).from_stacked(stacked)
        del stacked
        self.opt = make_online_optimizer(self.model, ocfg)
        self.chunk = make_packed_chunk_fn(mcfg, ocfg)
        names = {id(p): name for name, p in self.model.named_parameters()}

        # the checked steps, through the window's own call
        losses = [self.chunk(self.model, self.opt, self.pool_imgs, self.pool_masks,
                             draws_steps(self.first, 0, 1))]
        self.prog_grad = {i: compare.norms(training.first_gradient(
            self.opt, names, self.p0, index=i)) for i in self.checked}
        losses.append(self.chunk(self.model, self.opt, self.pool_imgs,
                                 self.pool_masks, draws_steps(self.first, 1, k)))
        losses = torch.cat(losses, dim=1)
        self.prog_losses = {i: losses[i].tolist() for i in self.checked}
        self.prog_delta = {i: compare.norms(training.delta(self.model, self.p0, index=i))
                           for i in self.checked}
        self.cursor = 0
        self._chunk(tr["warm_steps"]).cpu()

    def _chunk(self, steps: int) -> torch.Tensor:
        total = self.draws.flip.shape[1]
        start = self.cursor if self.cursor + steps <= total else 0
        stop = self.cursor = start + steps
        return self.chunk(self.model, self.opt, self.pool_imgs, self.pool_masks,
                          self.draws_steps(self.draws, start, stop))

    def unit(self) -> Tuple[int, float]:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.packed.chunk"):
            losses = self._chunk(self.steps_per_chunk)
        host_s = time.perf_counter() - t0
        with torch.profiler.record_function("bench.packed.sync"):
            losses.cpu()
        return losses.numel(), host_s

    def device_window(self) -> Dict[str, int]:
        self._chunk(self.tr["profile_steps"]).cpu()
        steps = self.s * self.tr["profile_steps"]
        return {"steps": steps, "work": steps}

    def gap_window(self) -> None:
        with torch.profiler.record_function("bench.packed.chunk"):
            losses = self._chunk(self.tr["gap_steps"])
        with torch.profiler.record_function("bench.packed.sync"):
            losses.cpu()

    def end_to_end(self, window, traced=None) -> Dict[str, float]:
        steps = sum(w for w, _ in window["units"])
        return {"finetune_s_per_seq": 2000 * window["seconds"] / steps}

    def check(self) -> Tuple[Dict[str, Tuple[float, str]], int]:
        del self.model, self.opt, self.pool_imgs, self.pool_masks, self.chunk
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        per = []
        for i in self.checked:
            numbers = training.reference_numbers(
                self.p0, self.batches[i], self.cfg, self.prog_losses[i],
                self.prog_grad[i], self.prog_delta[i])
            per.append({k: (v, f"sequence {i} {where}") for k, (v, where)
                        in numbers.items()})
        return training.worst(per), len(self.checked)


def setup(ctx) -> Job:
    return Job(ctx)
