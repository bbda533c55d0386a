"""int8 serving of adapted sequences, as ``--all_val --batched --infer_mode
int8`` ends: ``models/quantize.calibrate_int8_scales_batched`` over each
sequence's first frame (its state on its frame, on the host as the CLI holds
it), then ``parallel/batched_online.batched_infer`` with those scales as
``act_scales``, the model in ``compute_mode='int8'``.

The ``infer`` driver with one change: a pass is the calibration and then the
inference, in the timed window, the warm-up and both profiled windows
alike, so the card's time a real frame counts the calibration's kernels as
a deployment pays them. Traffic parameters as ``infer``'s.

``check`` holds every real frame's map of every pass to the int8 reference
(``reference/int8.py``), which calibrates its own scales on its float32
trunk (``code_gap_max``, ``code_gap_mean``, ``code_gap_worst_map``), and
every calibration of the run to the reference's scales: ``scale_gap``, the
largest relative gap of a scale that an int8 conv reads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.drivers import infer
from benchmark.reference import int8


class Job(infer.Job):
    def __init__(self, ctx):
        from osvos_torch.models.quantize import calibrate_int8_scales_batched

        self.calibrate = calibrate_int8_scales_batched
        self.margin = ctx.config["calibration"]["margin"]
        self.pass_scales: List[torch.Tensor] = []  # every calibration's
        self._ref = None
        super().__init__(ctx)

    def scales(self) -> torch.Tensor:
        """(S, n_trunk_convs) float32 act_scales on the card: each
        sequence's state on its first frame."""
        return self.calibrate(self.params, self.base[:, 0], self.mcfg,
                              margin=self.margin)

    def _infer(self, frames: int = None) -> np.ndarray:
        scales = self.scales()
        self.pass_scales.append(scales)
        lists = self.frames if frames is None else [f[:frames] for f in self.frames]
        return self.batched_infer(self.params, lists, self.mcfg,
                                  act_scales=scales, device=self.dev)

    def device_window(self) -> Dict[str, int]:
        """A pass; ``frames_run``: the frames its forward ran (the pad
        included), by the program's counter where it has one."""
        from osvos_torch.utils import profiling

        totals = getattr(profiling, "totals", dict)
        before = totals().get("infer.frames_run", 0)
        out = super().device_window()
        run = totals().get("infer.frames_run", 0) - before
        if run:
            out["frames_run"] = run
        return out

    def reference(self) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The reference's (distinct_frames, H, W) uint8 maps of each
        sequence, and its (S, n_trunk_convs) float64 scales."""
        if self._ref is None:
            maps, scales = [], []
            for i in range(len(self.lengths)):
                p = {k: v[i] for k, v in self.params.items()}
                frames = torch.from_numpy(self.base[i]).to(self.dev)
                s = int8.calibrate(p, frames[:1], self.cfg["stages"], self.margin)
                maps.append(int8.maps_u8(p, frames, self.cfg["stages"], s))
                scales.append(s)
            self._ref = maps, torch.stack(scales)
        return self._ref

    def reference_maps(self, levels: int = int8.LEVELS) -> List[torch.Tensor]:
        """The reference's maps; ``levels`` other than int8's recomputes
        them on fewer codes (the control) with the same scales."""
        maps, scales = self.reference()
        if levels == int8.LEVELS:
            return maps
        out = []
        for i in range(len(self.lengths)):
            p = {k: v[i] for k, v in self.params.items()}
            out.append(int8.maps_u8(p, torch.from_numpy(self.base[i]).to(self.dev),
                                    self.cfg["stages"], scales[i], levels))
        return out

    def scale_gap(self) -> Tuple[float, str]:
        """The largest |program - reference| / reference of a scale that an
        int8 conv reads, over every calibration of the run."""
        ref = self.reference()[1]
        read = torch.tensor(int8.int8_at(self.cfg["stages"]))
        worst, where = 0.0, "no calibration"
        for c, prog in enumerate(self.pass_scales):
            gap = ((prog.double().cpu() - ref) / ref).abs()[:, read]
            i, k = divmod(int(gap.argmax()), gap.shape[1])
            if float(gap[i, k]) > worst:
                worst = float(gap[i, k])
                where = f"calibration {c} sequence {i} int8 conv {k}"
        return worst, where

    def check(self, refs: List[torch.Tensor] = None
              ) -> Tuple[Dict[str, Tuple[float, str]], int]:
        numbers, count = super().check(refs)
        numbers["scale_gap"] = self.scale_gap()
        self.pass_scales = []
        return numbers, count


def setup(ctx) -> Job:
    return Job(ctx)
