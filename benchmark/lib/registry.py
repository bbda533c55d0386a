"""Everything the harness runs is found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. A cell names a configuration (``configs/<file>``, named in
``BENCHMARK.json``) and a traffic mix (``traffic/<traffic>.json``); the mix
names its driver (``drivers/<driver>.py``); a cell's correctness limits are
``limits/<cell>.json``; a per-layer metric is read by
``metrics/<metric>.py``; the launch counters that check a profiled window
are ``launches/*.json``. Adding a cell, a configuration or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class UnknownName(KeyError):
    """A name that ``BENCHMARK.json`` or the benchmark's files do not hold."""


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise UnknownName(f"not a valid name: {name!r}")
    return name


def spec() -> dict:
    """``BENCHMARK.json``."""
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise UnknownName(f"{path} is missing")
    return json.loads(path.read_text())


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == _checked(name):
            return e
    raise UnknownName(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str) -> dict:
    """The ``workloads`` entry of cell ``name``."""
    return _entry(spec()["workloads"], name, "cell")


def config(name: str) -> dict:
    """The configuration file of ``configs`` entry ``name``, as run."""
    entry = _entry(spec()["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def _json(folder: str, name: str) -> dict:
    path = BENCH_DIR / folder / f"{_checked(name)}.json"
    if not path.is_file():
        raise UnknownName(f"no {folder} file {path.name}")
    return json.loads(path.read_text())


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    """The correctness limits of a cell: {number: limit}."""
    return _json("limits", cell_name)


def driver(name: str) -> ModuleType:
    if not (BENCH_DIR / "drivers" / f"{_checked(name)}.py").is_file():
        raise UnknownName(f"no driver {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str) -> ModuleType:
    """The module of ``metrics/<name>.py`` (a metric name may hold dots,
    so it is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise UnknownName(f"no reader for metric {name!r}")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def launch_table() -> List[dict]:
    """Every ``launches/*.json`` row: a counter of the program and the
    kernels one counted launch puts on the device."""
    rows = []
    for path in sorted((BENCH_DIR / "launches").glob("*.json")):
        rows.extend(json.loads(path.read_text()))
    return rows


def end_to_end_of(cell_name: str) -> List[dict]:
    """The end-to-end metrics cell ``cell_name`` reports."""
    return [m for m in spec()["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_of(cell_name: str) -> List[dict]:
    """The per-layer metrics cell ``cell_name`` reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end_of(cell_name)}
    return [m for m in spec()["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def unit_of(metric_name: str) -> str:
    s = spec()
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] == metric_name:
            return m["unit"]
    raise UnknownName(f"no metric {metric_name!r}")


def as_dict(entries: List[dict]) -> Dict[str, dict]:
    return {e["name"]: e for e in entries}
