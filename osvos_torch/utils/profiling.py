"""Tracing: spans and counters inside the loops, a device trace, phase timing.

The port's one tracing module. ``span`` and ``count`` record into one
process-wide recorder, and only while a ``torch.profiler`` profile is
running (``device_trace``, or a caller's own profiler): the profiler is the
switch, so a run that traces nothing records nothing, enters no
``record_function`` and creates no CUDA event. While on, each span is also
a ``record_function`` range, so it sits on the trace's timeline over the
operations and kernels it launched.

A span records its name, its parent (the span it was entered in) and its
host interval (``time.perf_counter_ns``). A span given ``device=True``
also records a pair of CUDA events on the current stream when CUDA is in
use: its interval on the device's own clock, resolved when read
(``Span.device_ms``), never by a synchronize where the span ends. Spans are entered from one thread.
``PhaseTimer`` keeps the entry points' printed phase totals, and enters a
span of each phase's name. ``device_trace`` empties the recorder when it
ends, so a run that traces sequence after sequence holds one at a time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch
# its ``_is_profiler_enabled`` is torch's own flag, set while any profile runs
import torch.autograd.profiler as _autograd_profiler


class Span:
    """One span, entered by ``span`` while a profiler runs. ``parent`` is
    the index in ``spans()`` of the span it was entered in, or None."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "child_ns",
                 "_events", "_device_ms", "_range")

    def __init__(self, name: str, device: bool):
        self.name, self.parent = name, None
        self.start_ns = self.end_ns = self.child_ns = 0
        self._events = None
        if device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._device_ms = None
        self._range = torch.profiler.record_function(name)

    def __enter__(self) -> "Span":
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(len(_SPANS))
        _SPANS.append(self)
        self._range.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._range.__exit__(*exc)
        _OPEN.pop()
        if self.parent is not None:
            _SPANS[self.parent].child_ns += self.end_ns - self.start_ns

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """The host interval less what the spans entered in it cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The interval between the span's two CUDA events on the device's
        clock; None for a span that recorded none."""
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms


_SPANS: List[Span] = []
_OPEN: List[int] = []  # indices of the spans entered and not yet left
_COUNTS: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context manager that records the span ``name`` while a profiler
    runs, and does nothing otherwise. Names starting with ``bench.``,
    ``cu`` or ``cuda`` are not the program's: the benchmark's trace reader
    takes them for its own ranges and the CUDA runtime's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def spans() -> List[Span]:
    """Every span recorded since the last ``reset``, in the order entered."""
    return list(_SPANS)


def totals() -> Dict[str, int]:
    """Every counter's total since the last ``reset``."""
    return dict(_COUNTS)


def reset() -> None:
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, the CUDA activity into ``<log_dir>/trace.json`` when ``log_dir``
    is set; no-op otherwise. Spans record while it runs, and are dropped
    when it ends."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    finally:
        reset()


class PhaseTimer:
    """Accumulating wall-clock phase timer; with ``sync`` a phase ends
    when the card has finished its work. Each phase is also a ``span``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False) -> Iterator[None]:
        with span(name):
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
