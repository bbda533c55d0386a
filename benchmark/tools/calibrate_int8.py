#!/usr/bin/env python3
"""The readings that the int8 serving cell's correctness limits are set from.

    python3 benchmark/tools/calibrate_int8.py [--cell int8.infer_rank1of4] \\
        --seeds <s1> <s2> ... [--control N]

For each seed, one line of JSON: the numbers that ``run.py`` compares for a
sound run (the cell's set-up and one pass, against the int8 reference of
``reference/int8.py``), and for the first ``--control`` seeds the same
numbers read off the control and the faults, each in the program's place:
- ``int7``: the reference computed on int7 operands (codes -63..63, scale
  s / 63) with the same scales, one precision below the configuration's;
- ``wrong_scales``: the program's pass with sequence i run on sequence
  i + 1's scales (the last on the first's);
- ``altered``: the sound pass with one real map moved by 64 codes;
- ``dynamic`` (reported, no limit is set from it): the program's dynamic
  int8 path, each conv on the max of its own input, no calibration.
A limit lies above the largest sound reading, and each control and fault
reads over at least one limit (``PERF.md``).
"""

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _values(numbers) -> dict:
    return {k: v for k, (v, _) in numbers.items()}


def _as_pass(job, maps) -> "np.ndarray":
    """Each sequence's (distinct_frames, H, W) maps laid out as a pass of
    the program: (S, T, H, W), frame t the distinct frame t mod d."""
    import numpy as np

    d, t_max = job.tr["distinct_frames"], max(job.lengths)
    return np.stack([m.cpu().numpy()[np.arange(t_max) % d] for m in maps])


def readings(cell_name: str, seed: int, faults: bool, device,
             config: dict = None, traffic: dict = None) -> dict:
    import numpy as np
    import torch

    from benchmark.lib import registry

    cell = registry.cell(cell_name)
    config = config or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    ctx = types.SimpleNamespace(cell=cell_name, seed=seed, device=device,
                                config=config, traffic=traffic)
    job = registry.driver(traffic["driver"]).setup(ctx)
    job.unit()
    sound_pass = job.passes[-1].copy()
    sound = job.check()[0]
    out = {"cell": cell_name, "seed": seed, "sound": _values(sound),
           "where": {k: w for k, (_, w) in sound.items()}}
    if not faults:
        return out
    ref_scales = job.reference()[1].float().to(device)

    job.passes = [_as_pass(job, job.reference_maps(levels=63))]
    job.pass_scales = [ref_scales]
    out["int7"] = _values(job.check()[0])

    rolled = torch.roll(job.scales(), -1, 0)
    job.passes = [job.batched_infer(job.params, job.frames, job.mcfg,
                                    act_scales=rolled, device=device)]
    job.pass_scales = [rolled]
    out["wrong_scales"] = _values(job.check()[0])

    altered = sound_pass.copy()
    first = altered[0, 0].astype(np.int16)
    altered[0, 0] = np.where(first < 192, first + 64, first - 64).astype(np.uint8)
    job.passes = [altered]
    job.pass_scales = [job.scales()]
    out["altered"] = _values(job.check()[0])

    job.passes = [job.batched_infer(job.params, job.frames, job.mcfg, device=device)]
    job.pass_scales = []
    dynamic = _values(job.check()[0])
    dynamic.pop("scale_gap")
    out["dynamic"] = dynamic
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", default="int8.infer_rank1of4")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    args = parser.parse_args(argv)
    import torch

    for k, seed in enumerate(args.seeds):
        out = readings(args.cell, seed, k < args.control, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
