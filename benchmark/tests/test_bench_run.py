"""The run's control flow on the CPU at the tiny size, and the last line."""

import io
import json
import sys
import types
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import run
from benchmark.lib import registry

from .conftest import SEED, cells, tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell_name", cells())
def test_each_driver_runs_on_the_cpu_without_printing(cell_name):
    cfg, tr = tiny(cell_name)
    out = io.StringIO()
    with redirect_stdout(out):
        result = run.execute(cell_name, SEED, 0.0, False, torch.device("cpu"), cfg, tr)
    assert out.getvalue() == ""
    assert all(k in result for k in LINE_KEYS)
    assert result["attempted"] > 0 and result["device"]["platform"] == "cpu"
    # the CPU has no device trace: its end-to-end metrics are left out
    assert set(result["metrics"]) == {m["name"] for m in
                                      registry.end_to_end_of(cell_name)
                                      if m["source"] == "host_clock"}
    assert set(result["checks"]) == set(registry.limits(cell_name))
    assert run.banned_modules() == []


@pytest.mark.parametrize("cell_name", cells())
def test_one_seed_gives_the_same_inputs(cell_name):
    cfg, tr = tiny(cell_name)
    a = run.execute(cell_name, SEED, 0.0, False, torch.device("cpu"), cfg, tr)
    b = run.execute(cell_name, SEED, 0.0, False, torch.device("cpu"), cfg, tr)
    assert a["checks"] == b["checks"]


def test_without_cuda_it_exits_nonzero_and_prints_no_result(capsys):
    assert run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def _fake_run(monkeypatch, result):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "card", lambda: "a card, 700.00 W")
    monkeypatch.setattr(run, "execute", lambda *a, **k: dict(result))


RESULT = {"correct": True, "attempted": 3, "failed": 0,
          "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
          "device": {"platform": "gpu", "kind": "H", "count": 1,
                     "memory_peak_bytes": 1},
          "checks": {"loss_gap": {"value": 1e-3, "limit": 1e-2}},
          "_lines": ["loss_gap 0.001 limit 0.01"]}


def test_the_last_line_has_the_contracts_keys_and_the_checks_last(monkeypatch, capsys):
    _fake_run(monkeypatch, RESULT)
    assert run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in LINE_KEYS)
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "[check] loss_gap 0.001 limit 0.01"


def test_a_loaded_jax_refuses_the_result(monkeypatch, capsys):
    _fake_run(monkeypatch, RESULT)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
