"""The int8 serving cell on the CPU: its files resolve, a shrunk run is
correct against the int8 reference, its faults are not, and its three
readers read nothing where their spans, counters or kernels are absent and
the right share on a synthetic window."""

import copy
import io
import types
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import run
from benchmark.lib import counts_int8, registry
from benchmark.lib.groups import kernel_group
from osvos_torch.utils import profiling

from .conftest import SEED, TINY_STAGES

CELL = "int8.infer_rank1of4"
READERS = ("roofline.int8_conv", "int8.calibrate_ms_per_frame",
           "int8.static_conv_pct")


def shrunk():
    """(config, traffic) of the cell at the tiny size of the other cells'
    CPU tests."""
    cell = registry.cell(CELL)
    cfg = copy.deepcopy(registry.config(cell["config"]))
    tr = copy.deepcopy(registry.traffic(cell["traffic"]))
    cfg.update(stages=TINY_STAGES, side_channels=8, input_hw=[33, 49])
    tr.update(lengths=[3, 5, 2], distinct_frames=2, warm_frames=1)
    return cfg, tr


def _run():
    return run.execute(CELL, SEED, 0.0, False, torch.device("cpu"), *shrunk())


def test_the_cells_files_resolve():
    cell = registry.cell(CELL)
    cfg = registry.config(cell["config"])
    tr = registry.traffic(cell["traffic"])
    assert cfg["compute_mode"] == "int8" and cfg["calibration"]["margin"] == 1.05
    assert hasattr(registry.driver(tr["driver"]), "setup")
    assert set(registry.limits(CELL)) == {"code_gap_max", "code_gap_mean", "scale_gap"}
    assert {m["name"] for m in registry.per_layer_of(CELL)} == set(READERS)
    assert [m["name"] for m in registry.end_to_end_of(CELL)] == [
        "infer_kernel_ms_per_frame", "setup_s"]
    rows = [r for r in registry.launch_table()
            if r["module"] == "osvos_torch.ops.kernels.int8conv"]
    assert {r["counter"]: r["kernels"] for r in rows} == {
        "hopper_launches": ["int8_conv3x3_q_kernel"],
        "launches": ["int8_conv3x3_kernel<"]}


def test_a_shrunk_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] == 10
    assert set(result["checks"]) == set(registry.limits(CELL))


def test_it_prints_nothing_and_one_seed_gives_the_same_inputs():
    # test_bench_run.py's two tests of every cell, at this cell's shrunk size
    out = io.StringIO()
    with redirect_stdout(out):
        a = _run()
    assert out.getvalue() == ""
    assert set(a["metrics"]) == {"setup_s"}  # no device trace on the CPU
    assert _run()["checks"] == a["checks"]


def test_each_sequence_run_on_the_next_ones_scales(monkeypatch):
    from osvos_torch.models import quantize

    real = quantize.calibrate_int8_scales_batched

    def rolled(*args, **kwargs):
        return torch.roll(real(*args, **kwargs), -1, 0)

    monkeypatch.setattr(quantize, "calibrate_int8_scales_batched", rolled)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["scale_gap"]["value"] > result["checks"]["scale_gap"]["limit"]


def test_an_answer_altered_by_64_codes(monkeypatch):
    import osvos_torch.parallel.batched_online as batched

    real = batched.make_infer_fn
    calls = []

    def altered(*args, **kwargs):
        infer = real(*args, **kwargs)

        def fn(*a, **k):
            maps = infer(*a, **k)
            calls.append(1)
            # the window's first call: the first frame of a sequence
            return maps + 64 if len(calls) == 4 else maps
        return fn

    monkeypatch.setattr(batched, "make_infer_fn", altered)
    result = _run()
    assert not result["correct"]
    assert result["checks"]["code_gap_max"]["value"] >= 63


def _reading(events=(), per=None, kind="infer"):
    info = {"sequences": 5, "h": 480, "w": 854, "real_frames": 346,
            "stages": [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
                       [512, 512, 512]], "side_channels": 16}
    device = {"events": list(events), "busy_s": 1.0, "kernel_busy_s": 1.0,
              "window_s": 1.5, "per": per or {"work": 346}}
    return types.SimpleNamespace(cell=CELL, kind=kind, info=info, window=None,
                                 device=device)


def test_the_readers_read_nothing_without_their_spans(monkeypatch):
    profiling.reset()
    readers = {n: registry.metric_reader(n) for n in READERS}
    # no I1 kernel, no frames counted, an empty recorder, another kind of cell
    for r in (_reading(), _reading(per={"work": 346, "frames_run": 540}),
              _reading(kind="finetune"),
              types.SimpleNamespace(kind="infer", info={}, device=None)):
        assert all(readers[n].read(r) is None for n in READERS)
    # a program without the recorder (the benchmark laid over an older one)
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "totals")
    assert all(readers[n].read(_reading()) is None for n in READERS)


def test_the_roofline_on_a_synthetic_window():
    # 90 calls of 6 frames: 12 I1 launches a call, 0.4 ms each
    i1 = [("void int8_conv3x3_q_kernel(CUtensorMap)", 400.0 * k, 400.0 * k + 400.0)
          for k in range(90 * 12)]
    r = _reading(i1 + [("void nchwToNhwcKernel(x)", 0, 1e6)],
                 per={"work": 346, "frames_run": 540})
    bound = 90 * counts_int8.int8_bound_s(r.info["stages"], 6, 480, 854)
    got = registry.metric_reader("roofline.int8_conv").read(r)
    assert got == pytest.approx(100 * bound / (90 * 12 * 400e-6))
    assert kernel_group(i1[0][0]) == registry.metric_reader("roofline.int8_conv").I1
    # the count: the 12 convs after the stem, 2 N H W 9 C D operations each
    assert len(counts_int8.int8_convs(r.info["stages"], 1, 480, 854)) == 12
    assert counts_int8.int8_bound_s(r.info["stages"], 4, 480, 854) == pytest.approx(
        0.5875e-3, rel=1e-3)


def test_the_counter_share():
    reader = registry.metric_reader("int8.static_conv_pct")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("int8.convs_static", 36)
        profiling.count("int8.convs_dynamic", 12)
    try:
        assert reader.read(_reading()) == pytest.approx(75.0)
    finally:
        profiling.reset()
