"""Profiled windows on the card, checked against the program's launch
counters, and what the harness reads from them.

``device_window`` traces the device alone (CUPTI activity, little host
cost): kernel and copy intervals, their union (busy time) and the window's
host-clock length. Late in a run ``torch.profiler`` has returned windows
without device events or with a part of them (H100, torch 2.11), so a
window whose count of hand-written kernels is not what the counters of
``launches/*.json`` say was launched is profiled again, up to three times;
a window that never agrees raises ``TraceUnreadable`` and the traced run
fails: a metric is never read from a window that lost events.

``gap_window`` traces host and device together over a shorter stretch, to
name what the host was doing in the device's longest idle gaps.
"""

from __future__ import annotations

import importlib
import re
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.lib.groups import kernel_group
from benchmark.lib.registry import launch_table

Event = Tuple[str, float, float]  # name, start us, end us
TRIES = 3
COPIES = ("Memcpy", "Memset")


class TraceUnreadable(RuntimeError):
    """No profiled window agreed with the launch counters."""


def _counter_rows() -> List[Tuple[List[Tuple[object, str]], List[str], int]]:
    rows = []
    for row in launch_table():
        module = importlib.import_module(row["module"])
        names = row["counter"] if isinstance(row["counter"], list) \
            else [row["counter"]]
        rows.append(([(module, n) for n in names], row["kernels"],
                     row["per_launch"]))
    return rows


def _launched(rows) -> List[int]:
    return [sum(getattr(m, n) for m, n in counters) for counters, _, _ in rows]


def _named(name: str, kernel: str) -> bool:
    """Whether ``name`` holds the identifier ``kernel`` whole at its start
    (``wgrad_tma_kernel<`` is not ``stem_wgrad_tma_kernel<``)."""
    return re.search(r"(?<![A-Za-z0-9_])" + re.escape(kernel), name) is not None


def count_mismatches(events: List[Event], rows, before: List[int],
                     after: List[int]) -> List[str]:
    """Rows whose kernels in ``events`` are not ``per_launch`` times the
    launches the counters saw between ``before`` and ``after``."""
    bad = []
    for (counters, kernels, per), b, a in zip(rows, before, after):
        seen = sum(1 for name, _, _ in events if any(_named(name, k) for k in kernels))
        if seen != per * (a - b):
            bad.append(f"{'/'.join(n for _, n in counters)}: {seen} kernels "
                       f"for {a - b} launches x {per}")
    return bad


def _raw_events(prof) -> Tuple[List[Event], List[Event]]:
    """(device, host) events of a finished profile, from the profiler's raw
    records (no operator tree is built): name, start and end in us."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        item = (e.name(), start, start + e.duration_ns() / 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            # as an annotation over the kernels it launched: not device work
            if not (e.is_user_annotation() or item[0].startswith("bench.")):
                dev.append(item)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(item)
    return dev, host


def union_us(events: List[Event]) -> float:
    """The time in which at least one of ``events`` ran."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_window(fn: Callable[[], None]) -> dict:
    """``fn`` (which ends with a synchronize) under the device profiler:
    {'events', 'busy_s' (kernels and copies), 'kernel_busy_s', 'window_s',
    'retries'}."""
    from torch.profiler import ProfilerActivity, profile

    rows = _counter_rows()
    for attempt in range(TRIES):
        torch.cuda.synchronize()
        before = _launched(rows)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        after = _launched(rows)
        events = _raw_events(prof)[0]
        bad = count_mismatches(events, rows, before, after)
        if events and not bad:
            kernels = [e for e in events if not e[0].startswith(COPIES)]
            return {"events": events, "busy_s": union_us(events) / 1e6,
                    "kernel_busy_s": union_us(kernels) / 1e6,
                    "window_s": window_s, "retries": attempt}
        print(f"[profiler] window {attempt + 1}: {len(events)} device events; "
              f"{'; '.join(bad) or 'none seen'}", file=sys.stderr, flush=True)
    raise TraceUnreadable(f"{TRIES} profiled windows disagreed with the "
                          f"launch counters")


def group_seconds(events: List[Event]) -> Dict[str, float]:
    """Device seconds by ``kernel_group``."""
    out: Dict[str, float] = {}
    for name, s, e in events:
        g = kernel_group(name)
        out[g] = out.get(g, 0.0) + (e - s) / 1e6
    return out


def _gaps(events: List[Event], min_us: float) -> List[Tuple[float, float]]:
    gaps, end = [], None
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if end is not None and s - end >= min_us:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _host_name(cpu: List[Tuple[str, float, float]], t: float) -> str:
    """The benchmark's outermost span and the innermost host operation (not
    a CUDA runtime call) running at ``t``."""
    around = [c for c in cpu if c[1] <= t <= c[2]]
    if not around:
        return "host: outside any operation"
    spans = [c for c in around if c[0].startswith("bench.")]
    ops = [c for c in around if not c[0].startswith(("bench.", "cuda", "cu"))]
    outer = min(spans, key=lambda c: c[1])[0] if spans else "bench: none"
    inner = max(ops, key=lambda c: c[1])[0] if ops else "no operation"
    return f"{outer} / {inner}"


def gap_window(fn: Callable[[], None], min_us: float = 10.0, top: int = 10
               ) -> List[List]:
    """``fn`` under the host and device profiler: the device's idle gaps of
    at least ``min_us``, their seconds summed by what the host was doing
    at each gap's middle, the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, cpu = _raw_events(prof)
    by_name: Dict[str, float] = {}
    for a, b in _gaps(dev, min_us):
        name = _host_name(cpu, (a + b) / 2)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]
