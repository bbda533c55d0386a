"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- The recorder: with no profiler running, ``span`` is one shared null
  context that enters no ``record_function`` and records nothing, and
  ``count`` counts nothing; under a CPU ``torch.profiler``, spans nest with
  their parent and self time, counters count, the exported trace holds
  the spans, and ``reset`` empties the recorder.
- The loops: a tiny packed chunk and a tiny online chunk record one
  ``step.draw``, ``step.forward``, ``step.backward`` and ``step.optimizer`` a
  step (``step_mode='sequential'``: a forward and a backward a microstep),
  under a ``train.chunk`` a chunk call, and give the same losses,
  parameters and gradients bit for bit with the profiler on and off.
  ``batched_infer`` counts each call's buffer rows as run and its sequence's
  frames as real.
- The benchmark's readers of these spans and counters, after each cell's
  profiled windows ran at a tiny size under a CPU profiler: the host ones
  read a value, the device ones None (no CUDA event on the CPU), and each
  reads None from a recorder that holds nothing or a module without it.
- The online CLI's ``--profile_dir`` trace: each phase of the sequence, the
  fine-tune's range named by the sequence, its steps' spans inside it, and
  a recorder left empty.
"""

import contextlib
import io
import json
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import registry
from benchmark.tests.conftest import SEED, tiny
from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.models import OSVOS, init_osvos_params
from osvos_torch.parallel import batched_online as bo
from osvos_torch.parallel import packed
from osvos_torch.train import online
from osvos_torch.utils import profiling

TINY = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                           (16, 16, 16)), side_channels=8, compute_mode="fast")
STEPS = 3
CFG = OnlineConfig(n_steps=STEPS, n_ave_grad=2, lr=1e-3)
PHASES = ("step.draw", "step.forward", "step.backward", "step.optimizer")
READERS = {"fast.packed20": ["finetune.draw_ms_per_step",
                             "finetune.forward_ms_per_step",
                             "finetune.backward_ms_per_step",
                             "finetune.optimizer_ms_per_step"],
           "fast.infer_rank1of4": ["infer.fill_ms_per_frame",
                                   "infer.h2d_wait_ms_per_frame",
                                   "infer.launch_ms_per_frame",
                                   "infer.useful_frame_pct"]}
HOST = {"infer.fill_ms_per_frame", "infer.h2d_wait_ms_per_frame",
        "infer.launch_ms_per_frame", "infer.useful_frame_pct"}


@pytest.fixture(autouse=True)
def empty_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_it_enters_no_range_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.span("a")
    assert first is profiling.span("b", device=True)
    with first, profiling.span("c"):
        profiling.count("n", 3)
    timer = profiling.PhaseTimer()
    with timer.phase("p"):
        pass
    assert timer.counts == {"p": 1}
    assert profiling.spans() == [] and profiling.totals() == {}


def test_on_spans_nest_with_parent_and_self_time(tmp_path):
    with _profiler() as prof:
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
            with profiling.span("inner"):
                pass
            profiling.count("rows", 2)
            profiling.count("rows", 5)
        with profiling.PhaseTimer().phase("phase"):
            pass
    outer, inner, inner2, phase = profiling.spans()
    assert [s.name for s in (outer, inner, inner2, phase)] == \
        ["outer", "inner", "inner", "phase"]
    assert outer.parent is None and phase.parent is None
    assert inner.parent == 0 and inner2.parent == 0
    assert inner.host_ms >= 4 and outer.host_ms >= 6
    covered = inner.host_ms + inner2.host_ms
    assert outer.self_ms == pytest.approx(outer.host_ms - covered, abs=1e-6)
    assert 2 <= outer.self_ms < outer.host_ms
    assert inner.self_ms == inner.host_ms
    assert inner.device_ms is None  # not a device span, and no card
    assert profiling.totals() == {"rows": 7}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "inner", "phase"} <= names
    profiling.reset()
    assert profiling.spans() == [] and profiling.totals() == {}


def _pool(s, p=4, h=17, w=23):
    gen = torch.Generator().manual_seed(5)
    imgs = torch.rand((s, p, h, w, 3), generator=gen) * 100
    masks = (torch.rand((s, p, h, w, 1), generator=gen) > 0.7).float()
    return imgs, masks


def _packed_run(step_mode, traced):
    s = 2
    stacked = bo.stack_param_list([init_osvos_params(TINY, torch.Generator()
                                                     .manual_seed(i))
                                   for i in range(s)])
    model = packed.PackedOSVOS(TINY, s).from_stacked(stacked)
    opt = online.make_online_optimizer(model, CFG)
    chunk = packed.make_packed_chunk_fn(TINY, CFG, step_mode=step_mode)
    imgs, masks = _pool(s)
    draws = packed.stack_draws([online.make_draws(
        CFG, "pool", STEPS, imgs.shape[1], torch.Generator().manual_seed(9 + i))
        for i in range(s)])
    with _profiler() if traced else contextlib.nullcontext():
        losses = [chunk(model, opt, imgs, masks, packed.draws_steps(draws, 0, 2)),
                  chunk(model, opt, imgs, masks, packed.draws_steps(draws, 2, STEPS))]
    return losses, model


def _online_run(step_mode, traced):
    model = OSVOS(TINY)
    model.load_state_dict(init_osvos_params(TINY, torch.Generator().manual_seed(0)))
    opt = online.make_online_optimizer(model, CFG)
    chunk = online.make_chunk_fn(TINY, CFG, step_mode=step_mode)
    imgs, masks = (t[0] for t in _pool(1))
    draws = online.make_draws(CFG, "pool", STEPS, imgs.shape[0],
                              torch.Generator().manual_seed(9))
    with _profiler() if traced else contextlib.nullcontext():
        losses = [chunk(model, opt, imgs, masks, draws.steps(0, 2)),
                  chunk(model, opt, imgs, masks, draws.steps(2, STEPS))]
    return losses, model


@pytest.mark.parametrize("run", [_packed_run, _online_run], ids=["packed", "online"])
@pytest.mark.parametrize("step_mode", ["microbatch", "sequential"])
def test_a_chunk_records_each_phase_a_step_and_computes_the_same(run, step_mode):
    plain_losses, plain = run(step_mode, traced=False)
    assert profiling.spans() == []
    losses, model = run(step_mode, traced=True)
    for a, b in zip(plain_losses, losses):
        assert torch.equal(a, b)
    for (name, a), (_, b) in zip(plain.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name  # the last step's gradient

    recorded = profiling.spans()
    chunks = [i for i, s in enumerate(recorded) if s.name == "train.chunk"]
    assert len(chunks) == 2 and all(recorded[i].parent is None for i in chunks)
    per_step = 1 if step_mode == "microbatch" else CFG.n_ave_grad
    for name in PHASES:
        got = [s for s in recorded if s.name == name]
        n = per_step if name in ("step.forward", "step.backward") else 1
        assert len(got) == STEPS * n, name
        # the first chunk's 2 steps, then the second's 1
        assert [s.parent for s in got] == [chunks[0]] * 2 * n + [chunks[1]] * n
        assert all(recorded[s.parent].name == "train.chunk" for s in got)
        assert all(s.device_ms is None for s in got)  # no card


def test_batched_infer_counts_the_frames_it_runs_and_the_real_ones():
    lengths, h, w = [3, 5, 2], 17, 23
    stacked = bo.stack_param_list([init_osvos_params(TINY, torch.Generator()
                                                     .manual_seed(i))
                                   for i in range(len(lengths))])
    rng = np.random.RandomState(0)
    frames = [[rng.rand(h, w, 3).astype(np.float32) * 100 for _ in range(n)]
              for n in lengths]
    chunk_t = 2  # calls of 2 frames: the budget of 2 frames of 3 sequences
    budget = chunk_t * len(lengths) * h * w * (3 * 4 + 320)
    plain = bo.batched_infer(stacked, frames, TINY, hbm_budget_bytes=budget,
                             device="cpu")
    assert profiling.spans() == [] and profiling.totals() == {}
    with _profiler():
        maps = bo.batched_infer(stacked, frames, TINY, hbm_budget_bytes=budget,
                                device="cpu")
    np.testing.assert_array_equal(maps, plain)
    calls = len(lengths) * -(-max(lengths) // chunk_t)
    assert profiling.totals() == {"infer.frames_run": calls * chunk_t,
                                  "infer.frames_real": sum(lengths)}
    recorded = profiling.spans()
    names = [s.name for s in recorded]
    assert names[0] == "infer.call" and names.count("infer.call") == 1
    assert names.count("infer.load") == 1 + len(lengths)
    for name in ("infer.fill", "infer.h2d", "infer.forward"):
        assert names.count(name) == calls, name
    assert names.count("infer.gather") == 1
    assert all(s.parent == 0 for s in recorded[1:])
    assert 0 < recorded[0].self_ms < recorded[0].host_ms


def _reading(job):
    return types.SimpleNamespace(cell=None, kind=job.kind, info=job.info,
                                 window=None, device=None)


@pytest.mark.parametrize("cell_name", sorted(READERS))
def test_the_readers_after_a_tiny_cell_under_a_cpu_profiler(cell_name, monkeypatch):
    cfg, tr = tiny(cell_name)
    ctx = types.SimpleNamespace(cell=cell_name, seed=SEED, device=torch.device("cpu"),
                                config=cfg, traffic=tr)
    job = registry.driver(tr["driver"]).setup(ctx)
    names = READERS[cell_name]
    assert set(names) <= {m["name"] for m in registry.per_layer_of(cell_name)}
    readers = {n: registry.metric_reader(n) for n in names}
    reading = _reading(job)
    assert all(readers[n].read(reading) is None for n in names)  # nothing recorded
    with _profiler():
        job.device_window()
        job.gap_window()
    for n in names:
        value = readers[n].read(reading)
        if n in HOST:
            assert value is not None and value > 0, n
        else:
            assert value is None, n
    if cell_name == "fast.infer_rank1of4":
        real, run = sum(tr["lengths"]), len(tr["lengths"]) * max(tr["lengths"])
        assert readers["infer.useful_frame_pct"].read(reading) == pytest.approx(
            100 * real / run)
    # a program without the recorder (the benchmark laid over an older one)
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "totals")
    assert all(readers[n].read(reading) is None for n in names)
    # a reading of the other kind of cell
    other = types.SimpleNamespace(kind="other")
    assert all(readers[n].read(other) is None for n in names)


def test_the_cli_trace_holds_the_phases_the_fine_tune_and_its_steps(tmp_path):
    from osvos_torch.cli import train_online as cli
    from osvos_torch.data.synthetic import DEFAULT_VAL_SEQS, generate
    from osvos_torch.utils.checkpoint import save_checkpoint

    db_root = generate(str(tmp_path / "davis"), height=33, width=49, n_frames=2)
    cfg = ModelConfig(stages=cli.TINY_STAGES, side_channels=8)
    parent = save_checkpoint(str(tmp_path / "parent.pt"),
                             init_osvos_params(cfg, torch.Generator().manual_seed(0)),
                             step=0)
    seq = DEFAULT_VAL_SEQS[0]
    trace_dir = tmp_path / "trace"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--db_root", db_root, "--parent", parent, "--tiny",
                         "--device", "cpu", "--steps", "2", "--n_ave_grad", "2",
                         "--compute_mode", "fast", "--no_save",
                         "--seq_name", seq,
                         "--save_root", str(tmp_path / "runs"),
                         "--profile_dir", str(trace_dir)]) == 0
    assert profiling.spans() == []  # the trace's end empties the recorder
    with open(trace_dir / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def within(name, outer):
        start, end = outer["ts"], outer["ts"] + outer["dur"]
        return [e for e in events if e["name"] == name
                and start <= e["ts"] and e["ts"] + e["dur"] <= end]

    names = {e["name"] for e in events}
    assert {"decode", "pool build", "fine-tune steps", "inference",
            "PNG writes"} <= names
    steps, = [e for e in events if e["name"] == "fine-tune steps"]
    fine_tune, = within(f"fine_tune/{seq}", steps)
    for name in PHASES:
        assert len(within(name, fine_tune)) == 2, name
