"""The trace reading on synthetic events: busy time, the launch-counter
check, idle gaps named by the host's work, and the per-layer readers."""

import types

import pytest

from benchmark.drivers import infer
from benchmark.lib import registry, trace
from benchmark.lib.counts import seq_wgrad_bound_s
from benchmark.lib.groups import kernel_group


def test_busy_time_is_the_union_of_intervals():
    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert trace.union_us(ev) == 25


def test_a_window_that_lost_kernels_is_found():
    mod = types.SimpleNamespace(n=0)
    rows = [([(mod, "n")], ["wgrad_tma_kernel<", "wgrad_tma_reduce_kernel"], 2)]
    ev = [("void wgrad_tma_kernel<64, 64>(x)", 0, 1),
          ("wgrad_tma_reduce_kernel(y)", 1, 2)]
    assert trace.count_mismatches(ev, rows, [0], [1]) == []
    assert trace.count_mismatches(ev[:1], rows, [0], [1])


def test_every_counter_of_the_table_exists():
    import importlib

    for row in registry.launch_table():
        module = importlib.import_module(row["module"])
        for name in ([row["counter"]] if isinstance(row["counter"], str)
                     else row["counter"]):
            assert isinstance(getattr(module, name), int)


def test_gaps_are_named_by_the_host():
    cpu = [("bench.finetune.chunk", 0, 100), ("aten::index_select", 40, 60),
           ("cudaLaunchKernel", 45, 55)]
    assert trace._host_name(cpu, 50) == "bench.finetune.chunk / aten::index_select"
    assert trace._gaps([("k", 0, 10), ("k", 30, 40), ("k", 41, 50)], 5) == [(10, 30)]


def test_kernel_groups():
    assert kernel_group("void conv3x3_tma_kernel<64, 2, 2>(a)") == "flatconv dz, trunk (B3)"
    assert kernel_group("Memcpy HtoD (Pageable -> Device)") == "memcpy and memset"
    assert kernel_group("void (anonymous namespace)::tail_kernel<4>(Params)") == \
        "fused_head.cu fused-head tail (B1)"
    assert kernel_group("void int8_conv3x3_q_kernel(CUtensorMap)") == \
        kernel_group("void int8_conv3x3_kernel<64>(Args)") == "int8conv.cu int8 conv (I1)"


STAGES = [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]]


def _reading(kind, sequences=1, events=()):
    info = {"sequences": sequences, "batch": 5, "h": 480, "w": 854, "stages": STAGES,
            "side_channels": 16, "flops_per_step": 3.866e12,
            "flops_per_frame": 258.2e9, "real_frames": 1376}
    return types.SimpleNamespace(
        kind=kind, info=info, window={"seconds": 10.0, "units": [(500, 2.0), (500, 2.0)]},
        device={"events": list(events), "busy_s": 0.95, "kernel_busy_s": 0.9, "window_s": 1.0,
                "per": {"steps": 10, "work": 100}})


@pytest.mark.parametrize("name", [m["name"] for m in registry.spec()["per_layer"]])
def test_a_reader_finds_nothing_outside_its_cells(name):
    reader = registry.metric_reader(name)
    other = "infer" if "finetune" in name or "roofline" in name else "finetune"
    assert reader.read(_reading(other)) is None


def test_readers_on_a_synthetic_window():
    r = _reading("finetune", sequences=20,
                 events=[("void wgrad_tma_kernel<64, 64>(a)", 0, 8e4)])
    assert registry.metric_reader("mfu.finetune").read(r) == pytest.approx(
        100 * 3.866e12 * 1000 / (10 * 989e12))
    # 0.9 busy s over 100 units, 1000 units in 10 s
    assert registry.metric_reader("device.idle_pct.finetune").read(r) == pytest.approx(10)
    # 4 host s over 1000 sequence-steps of 20 sequences: 50 packed steps
    assert registry.metric_reader("finetune.host_ms_per_step").read(r) == pytest.approx(80.0)
    # 80 ms of wgrad kernels over 10 sequence-steps, half a packed step
    bound = seq_wgrad_bound_s(STAGES, 5, 480, 854, 20)
    assert registry.metric_reader("roofline.seq_wgrad").read(r) == pytest.approx(
        100 * bound / 0.16, rel=1e-3)


def test_infer_readers_on_a_synthetic_window():
    r = _reading("infer", sequences=5,
                 events=[("Memcpy HtoD (Pageable -> Device)", 0, 5e4)])
    # 1000 real frames in the 10 s window
    assert registry.metric_reader("infer.host_frames_per_s").read(r) == pytest.approx(100)
    assert registry.metric_reader("mfu.infer").read(r) == pytest.approx(
        100 * 258.2e9 * 1000 / (10 * 989e12))
    assert registry.metric_reader("device.idle_pct.infer").read(r) == pytest.approx(10)
    # 50 ms of copies over the profiled pass's 100 real frames
    assert registry.metric_reader("infer.h2d_ms_per_frame").read(r) == pytest.approx(0.5)
    # the end-to-end metric: 0.9 kernel s over the pass's 100 real frames,
    # and nothing without a device window
    job = types.SimpleNamespace()
    assert infer.Job.end_to_end(job, r.window, r.device) == {
        "infer_kernel_ms_per_frame": pytest.approx(9.0)}
    assert infer.Job.end_to_end(job, r.window, None) == {}
