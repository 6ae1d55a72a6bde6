"""The device trace of a traced run, and what is reduced from it.

``DeviceTrace`` runs ``torch.profiler``'s Kineto back end (CUPTI on the
card) without building its Python event tree, which would take minutes at
the launch rates of a serving window. The reductions below are plain
functions of (start, end) intervals in nanoseconds, so the tests can hold
them to hand-made traces:

- the device is busy where any operation runs on it: the union of the
  device intervals, whatever the streams (a sum would count two
  overlapping kernels twice);
- an idle gap is a stretch of the traced window where no operation runs,
  labelled by the host work that overlaps it most (the harness's own spans
  and the profiler's host events);
- a kernel is attributed to the flush whose dispatch launched it, by the
  CUDA call that the profiler correlates with it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

NO_HOST_WORK = "no host work recorded"


@dataclass
class Event:
    name: str
    start: int                      # ns, the profiler's clock
    end: int
    device: bool
    correlation: int = 0
    thread: int = 0


@dataclass
class Span:
    """A harness span around a call into the program, on the profiler's
    clock (``time.time_ns``, checked against a marker)."""
    name: str
    start: int
    end: int
    thread: int = 0
    bucket: int = 0


def merge(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def idle_gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    gaps, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def label_gap(gap: tuple[int, int], host: list) -> str:
    """The name of the host work that overlaps the gap longest, summed over
    threads; ``host`` holds objects with ``name``, ``start`` and ``end``."""
    a, b = gap
    overlap: dict[str, int] = defaultdict(int)
    for e in host:
        o = min(b, e.end) - max(a, e.start)
        if o > 0:
            overlap[e.name] += o
    if not overlap:
        return NO_HOST_WORK
    return max(overlap.items(), key=lambda kv: kv[1])[0]


def attribute(kernels: list[Event], api: dict[int, Event], spans: list[Span]) -> list:
    """The dispatch span each kernel was launched from, or None: the span
    that holds the time of the CUDA call correlated with the kernel (on the
    same thread where two spans hold it), else the last span started before
    the kernel ran."""
    spans = sorted(spans, key=lambda s: s.start)
    out = []
    for k in kernels:
        call = api.get(k.correlation)
        chosen: Optional[Span] = None
        if call is not None:
            holding = [s for s in spans if s.start <= call.start <= s.end]
            same = [s for s in holding if s.thread == call.thread]
            chosen = (same or holding or [None])[0]
        if chosen is None:
            before = [s for s in spans if s.start <= k.start]
            chosen = before[-1] if before else None
        out.append(chosen)
    return out


class DeviceTrace:
    """Start and stop the profiler around the traced window; the events come
    back as ``Event``s. The marker ties the harness's clock to the
    profiler's."""

    def __init__(self) -> None:
        import torch
        from torch._C._profiler import ProfilerActivity

        self._torch = torch
        self._activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self._config = None

    def start(self) -> None:
        from torch._C._profiler import ProfilerConfig, ProfilerState
        from torch.autograd.profiler import _enable_profiler, _prepare_profiler
        try:
            from torch._C._profiler import _ExperimentalConfig as Experimental
        except ImportError:                                   # older releases
            from torch._C._profiler import ExperimentalConfig as Experimental
        try:
            experimental = Experimental(profile_all_threads=True)
        except TypeError:                                     # no such option: this thread's ops
            experimental = Experimental()
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                      experimental)
        _prepare_profiler(self._config, self._activities)
        _enable_profiler(self._config, self._activities)

    def marker(self, name: str) -> int:
        """Record a zero-length host op; returns ``time.time_ns()`` at it."""
        with self._torch.profiler.record_function(name):
            return time.time_ns()

    def stop(self) -> list[Event]:
        from torch.autograd.profiler import _disable_profiler
        from torch.autograd import DeviceType

        result = _disable_profiler()
        events = []
        for e in result.events():
            start = int(e.start_ns())
            events.append(Event(
                name=e.name(), start=start, end=start + int(e.duration_ns()),
                device=e.device_type() == DeviceType.CUDA,
                correlation=int(e.correlation_id()), thread=int(e.start_thread_id())))
        return events


def is_cuda_call(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cuLaunch")


def breakdown(device: list[Event], host: list, lo: int, hi: int, group_of, top: int = 10) -> dict:
    """The device operations that took most time (by group and name) and the
    longest idle gaps with what the host was doing across each."""
    by_name: dict[str, int] = defaultdict(int)
    for e in device:
        if e.end > lo and e.start < hi:
            by_name[e.name] += min(e.end, hi) - max(e.start, lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(e.start, e.end) for e in device], lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[f"{group_of(name)} | {name[:120]}", ns / 1e9] for name, ns in ops],
        "idle_gaps": [[label_gap(g, host), (g[1] - g[0]) / 1e9] for g in gaps],
    }


def group_totals(device: list[Event], lo: int, hi: int, group_of) -> dict:
    totals: dict[str, int] = defaultdict(int)
    for e in device:
        if e.end > lo and e.start < hi:
            totals[group_of(e.name)] += min(e.end, hi) - max(e.start, lo)
    return {k: v / 1e9 for k, v in sorted(totals.items(), key=lambda kv: -kv[1])}
