"""Batched inference of adapted sequences, as ``--all_val --batched`` ends:
``parallel/batched_online.batched_infer`` over S stacked per-sequence
states and ragged lists of preprocessed float32 frames on the host, the
(S, T, H, W) uint8 maps returned to the host.

Traffic parameters: ``lengths`` (frames of each sequence, in the order the
program's rank takes them; ``sequences`` names them and is not read),
``distinct_frames`` (different frames a sequence, referenced in turn, as a
decode would leave them in memory) and ``warm_frames`` (the frames a
sequence of the warm-up pass: calls of the shape every pass makes). One
unit of work is a real frame whose map reached the host; a pass is one
``batched_infer`` call over every sequence, padded to the longest, and
both profiled windows run whole passes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib import counts, inputs, training
from benchmark.reference import osvos


class Job:
    kind = "infer"

    def __init__(self, ctx):
        from osvos_torch.parallel.batched_online import batched_infer

        cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.batched_infer = batched_infer
        self.mcfg = training.model_config(cfg)
        h, w = cfg["input_hw"]
        self.lengths = list(tr["lengths"])
        s = len(self.lengths)
        self.info = {"sequences": s, "h": h, "w": w, "stages": cfg["stages"],
                     "side_channels": cfg["side_channels"],
                     "real_frames": sum(self.lengths),
                     "flops_per_frame": counts.forward_flops(
                         cfg["stages"], cfg["side_channels"], 1, h, w)}

        # S adapted states, and each sequence's distinct frames on the host
        self.params = inputs.make_params(cfg["stages"], cfg["side_channels"],
                                         seed, dev, copies=s)
        d = tr["distinct_frames"]
        base = inputs.make_frames(s * d, h, w, seed, dev).cpu().numpy()
        self.base = base.reshape(s, d, h, w, 3)
        self.frames = [[self.base[i, t % d] for t in range(n)]
                       for i, n in enumerate(self.lengths)]
        self.passes: List[np.ndarray] = []  # every pass's maps, all checked
        self._infer(tr["warm_frames"])

    def _infer(self, frames: int = None) -> np.ndarray:
        lists = self.frames if frames is None else [f[:frames] for f in self.frames]
        return self.batched_infer(self.params, lists, self.mcfg, device=self.dev)

    def unit(self) -> Tuple[int, float]:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.infer.pass"):
            maps = self._infer()
        host_s = time.perf_counter() - t0
        self.passes.append(maps)
        return self.info["real_frames"], host_s

    def device_window(self) -> Dict[str, int]:
        self._infer()
        return {"work": self.info["real_frames"]}

    def gap_window(self) -> None:
        with torch.profiler.record_function("bench.infer.pass"):
            self._infer()

    def end_to_end(self, window, traced=None) -> Dict[str, float]:
        """The card's kernel ms a real frame, from the device window (a
        whole pass; padding frames run but are not counted). The frames a
        second of the timed window are paced by the host's buffer fill and
        pageable copies, and read as ``infer.host_frames_per_s``."""
        if traced is None:
            return {}
        return {"infer_kernel_ms_per_frame":
                1e3 * traced["kernel_busy_s"] / traced["per"]["work"]}

    def reference_maps(self, conv=osvos.f32_conv) -> List[torch.Tensor]:
        """Each sequence's (distinct_frames, H, W) uint8 maps by the
        reference, from the benchmark's own weights and frames."""
        out = []
        for i in range(len(self.lengths)):
            p = {k: v[i] for k, v in self.params.items()}
            out.append(osvos.maps_u8(p, torch.from_numpy(self.base[i]).to(self.dev),
                                     self.cfg["stages"], conv))
        return out

    def check(self, refs: List[torch.Tensor] = None
              ) -> Tuple[Dict[str, Tuple[float, str]], int]:
        """Every real frame's map of every pass against the reference's
        (``refs``: other maps in the reference's place)."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        refs = self.reference_maps() if refs is None else refs
        d = self.tr["distinct_frames"]
        worst, where, total, count, widest = -1.0, "", 0.0, 0, 0.0
        for p, maps in enumerate(self.passes):
            for i, n in enumerate(self.lengths):
                ref = refs[i][torch.arange(n, device=self.dev) % d]
                prog = torch.from_numpy(maps[i, :n]).to(self.dev)
                gap = (prog.to(torch.int16) - ref.to(torch.int16)).abs().float()
                per_map = gap.mean((1, 2))
                j = int(per_map.argmax())
                if float(per_map[j]) > worst:
                    worst, where = float(per_map[j]), f"pass {p} sequence {i} frame {j}"
                total += float(per_map.sum())
                count += n
                widest = max(widest, float(gap.max()))
        self.passes = []
        return {"code_gap_max": (widest, f"{count} maps"),
                "code_gap_mean": (total / count, f"{count} maps"),
                "code_gap_worst_map": (worst, where)}, count


def setup(ctx) -> Job:
    return Job(ctx)
