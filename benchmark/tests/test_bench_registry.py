"""Every name in BENCHMARK.json resolves to its files, an unknown name is
refused, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark.lib import registry

from .conftest import cells

SPEC = registry.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell_name", cells())
def test_every_name_of_a_cell_resolves(cell_name):
    cell = registry.cell(cell_name)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    assert hasattr(registry.driver(traffic["driver"]), "setup")
    assert registry.limits(cell_name)
    assert cfg["stages"] and cfg["input_hw"]
    assert registry.end_to_end_of(cell_name)
    for m in registry.per_layer_of(cell_name):
        assert callable(registry.metric_reader(m["name"]).read)


@pytest.mark.parametrize("lookup, name", [
    (registry.cell, "no.such.cell"), (registry.config, "no_such_config"),
    (registry.traffic, "no_such_traffic"), (registry.driver, "no_such_driver"),
    (registry.metric_reader, "no.such.metric"), (registry.limits, "no.such.cell"),
    (registry.cell, "../BENCHMARK"), (registry.traffic, "a/b"),
    (registry.metric_reader, "has space")])
def test_an_unknown_name_is_refused(lookup, name):
    with pytest.raises(registry.UnknownName):
        lookup(name)


def test_top_level_keys_and_sizes():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])


def test_entries_keep_their_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = []
    for section, want in keys.items():
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell_name", cells())
def test_each_cell_reports_what_its_metrics_move(cell_name):
    e2e = {m["name"] for m in registry.end_to_end_of(cell_name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = registry.per_layer_of(cell_name)
    assert per and all(m["moves"] in e2e for m in per)


def test_configs_are_files_under_the_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/") and not c["reduced"]
        assert registry.config(c["name"])["source"] == c["source"]
