"""Tracing and phase timing.

Counterpart of ``osvos_tpu/utils/profiling.py``, over ``torch.profiler``:
a device trace (Chrome trace format, readable in Perfetto) and named ranges
on its timeline around the hot phases, plus an accumulating phase timer that
costs nothing when no trace is taken.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, the CUDA activity into ``<log_dir>/trace.json`` when ``log_dir``
    is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range on the trace's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulating wall-clock phase timer; with ``sync`` a phase ends
    when the card has finished its work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "mean_s": round(v / max(self.counts[k], 1), 4),
                    "count": self.counts[k]}
                for k, v in self.totals.items()}
