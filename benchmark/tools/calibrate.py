#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 benchmark/tools/calibrate.py <cell> --seeds <s1> <s2> ... [--control N]

For each seed, one line of JSON: the numbers that ``run.py`` compares for
a sound run of the program (its set-up and, for serving, one pass), and for
the first ``--control`` seeds, the same numbers read off the control and
the faults, each put in the program's place against the float32
reference:
- ``control``: training, the reference computed on int8 conv operands,
  one precision below the configuration's bf16 (``reference/control.py``);
  serving, the program's own int8 path (I1, dynamic scales) switched on;
- ``half_batch`` (training): the reference with half of each step's batch
  left out, the mean taken over the rest;
- ``unchanged`` (training): a step that returns its state unchanged reads
  1 by ``delta_gap``'s measure and needs no run.
A limit lies above the largest sound reading and below the smallest
reading of the control and of the faults (``PERF.md``).
"""

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell_name: str, seed: int, faults: bool, device,
             config: dict = None, traffic: dict = None) -> dict:
    import torch

    from benchmark.lib import registry, training
    from benchmark.reference import compare, control, osvos

    cell = registry.cell(cell_name)
    config = config or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    ctx = types.SimpleNamespace(cell=cell_name, seed=seed, device=device,
                                config=config, traffic=traffic)
    job = registry.driver(traffic["driver"]).setup(ctx)
    if job.kind == "infer":
        job.unit()
    sound, _ = job.check()
    out = {"cell": cell_name, "seed": seed,
           "sound": {k: v for k, (v, _) in sound.items()},
           "where": {k: w for k, (_, w) in sound.items()}}
    if not faults:
        return out
    if job.kind == "infer":
        # the program's own path one precision down: its int8 trunk (I1),
        # dynamic scales, over the same states and frames
        int8 = training.model_config(config, mode="int8")
        job.passes = [job.batched_infer(job.params, job.frames, int8, device=device)]
        out["control"] = {k: v for k, (v, _) in job.check()[0].items()}
        return out
    o = config["online"]
    ctl, half = [], []
    for i in job.checked:
        batches = job.batches[i]
        args = (config["stages"], o["lr"], o["momentum"], o["weight_decay"])
        ref = osvos.steps(job.p0, batches, *args)
        for name, conv, sub in (("control", control.int8_conv, batches),
                                ("half_batch", osvos.f32_conv,
                                 [(im[:im.shape[0] - im.shape[0] // 2],
                                   mk[:mk.shape[0] - mk.shape[0] // 2])
                                  for im, mk in batches])):
            got = osvos.steps(job.p0, sub, *args, conv=conv)
            numbers = compare.training_numbers(
                got[0], ref[0], compare.norms(got[1]), compare.norms(ref[1]),
                compare.norms({k: got[2][k].double() - job.p0[k].double() for k in job.p0}),
                compare.norms({k: ref[2][k].double() - job.p0[k].double() for k in job.p0}))
            (ctl if name == "control" else half).append(numbers)
    out["control"] = {k: v for k, (v, _) in training.worst(ctl).items()}
    out["half_batch"] = {k: v for k, (v, _) in training.worst(half).items()}
    out["unchanged"] = {"delta_gap": 1.0}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cell")
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
