#!/usr/bin/env python3
"""The benchmark of ``osvos_torch``: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the CUDA devices the cell
asks for. The cell's driver builds the program's objects and the inputs
from the seed on the card, runs the checked first steps and warms every
shape (set-up, ``setup_s``), then runs whole units of work (a chunk of
fine-tune steps, an inference pass) until ``--seconds`` have passed; the
unit that runs at the deadline ends the window. With ``--trace 1`` two
profiled windows follow it: the device alone, checked against the
program's launch counters, and host and device together for the idle gaps;
the line then carries the per-layer metrics instead of the end-to-end
ones. The device window follows a ``--trace 0`` run too where one of the
cell's end-to-end metrics has the source ``device_trace``. After the window the program's state is freed and the reference
(``reference/``) decides ``correct``; the numbers it compared close
standard error and the result's line.

Exit codes: 0 with a result line; 2 without the CUDA devices the cell
needs; 3 when JAX or the JAX package was loaded; 4 when no profiled window
agreed with the launch counters; 1 on any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level modules that may not be loaded in the process that prints
BANNED = ("jax", "jaxlib", "flax", "osvos_tpu")


def banned_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device,
            config: dict = None, traffic: dict = None) -> dict:
    """One run of a cell on ``device``; returns the result (the line's
    keys). ``config`` and ``traffic`` replace the cell's files (the CPU
    tests shrink them)."""
    import torch

    from benchmark.lib import registry
    from benchmark.lib.trace import device_window, gap_window, group_seconds
    from benchmark.reference import compare

    cell = registry.cell(cell_name)
    config = config or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    limits = registry.limits(cell_name)
    ctx = types.SimpleNamespace(cell=cell_name, seed=seed, device=device,
                                config=config, traffic=traffic)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    job = registry.driver(traffic["driver"]).setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    units, walls = [], []
    t0 = time.perf_counter()
    while True:
        units.append(job.unit())
        walls.append(time.perf_counter() - t0 - sum(walls))
        if time.perf_counter() - t0 >= seconds:
            break
    window = {"seconds": time.perf_counter() - t0, "units": units}

    # the profiled windows come after the timed one: once torch.profiler
    # has traced the card, the process's later launches run slower. The
    # device window also runs without --trace where an end-to-end metric
    # of the cell is read from the device's trace.
    traced = gaps = None
    from_trace = any(m["source"] == "device_trace"
                     for m in registry.end_to_end_of(cell_name))
    if cuda and (trace or from_trace):
        per = {}
        traced = device_window(lambda: per.update(job.device_window()))
        traced["per"] = per
    if trace:
        gaps = gap_window(job.gap_window)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    numbers, compared = job.check()
    values = {k: v for k, (v, _) in numbers.items()}
    correct, lines = compare.judge(values, limits)
    where = {k: w for k, (_, w) in numbers.items()}

    metrics = {}
    if trace:
        reading = types.SimpleNamespace(cell=cell_name, kind=job.kind,
                                        info=job.info, window=window,
                                        device=traced)
        for m in registry.per_layer_of(cell_name):
            value = registry.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = job.end_to_end(window, traced)
        e2e["setup_s"] = setup_s
        for m in registry.end_to_end_of(cell_name):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct),
              "attempted": sum(w for w, _ in units),
              "failed": sum(values[k] > limits[k] for k in limits),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        groups = sorted(group_seconds(traced["events"]).items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [[k, v] for k, v in groups[:10]],
                               "idle_gaps": gaps}
    result["compared"] = {"sequences or maps": compared, "values": values,
                          "where": where}
    result["units"] = [[w, h, t] for (w, h), t in zip(units, walls)]
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    result["_lines"] = lines
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.lib import registry
    from benchmark.lib.trace import TraceUnreadable

    chips = registry.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    the_card = card()
    print(f"[card] {the_card}", file=sys.stderr, flush=True)
    try:
        result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    except TraceUnreadable as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    lines = result.pop("_lines")
    checks = result.pop("checks")
    result["card"] = the_card
    result["checks"] = checks
    for line in lines:
        print(f"[check] {line}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
