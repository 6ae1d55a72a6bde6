"""Lightweight metrics registry with Prometheus text exposition.

Counters, gauges and fixed-bucket histograms; safe from both the event loop
and worker threads. Feeds the BASELINE observability metrics (img/s, batch
occupancy, p50/p99) via ``/monitor/metrics``.

Spans and waits time the serving path into the registry's histograms
(``<name>_ms``): ``span`` around work on the thread that does it, ``waited``
for the time a piece of work sat in an executor's queue, from the hand-off
on the event loop to the moment a worker starts it. While ``torch.profiler``
records, a span also opens ``record_function("ics.<name>", args)``, so it
lands among the profiler's host events, on the profiler's clock, on the
thread that ran it; with the profiler off it costs two clock reads, a flag
check and one observation.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_right
from typing import Optional, Sequence

_DEFAULT_BUCKETS = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
)
# spans and waits run from microseconds (padding a batch) to seconds
SPAN_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
)


def log_buckets(lo: float, hi: float, ratio: float) -> tuple:
    """Bounds from ``lo`` to at least ``hi``, each ``ratio`` times the last:
    an interpolated quantile is then within ``ratio - 1`` of the exact one."""
    n = math.ceil(math.log(hi / lo) / math.log(ratio))
    return tuple(lo * ratio ** i for i in range(n + 1))


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} counter\n"
            f"{self.name} {self._value}\n"
        )


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = value

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} gauge\n"
            f"{self.name} {self._value}\n"
        )


class Histogram:
    """Fixed buckets (milliseconds by convention) + quantile estimates."""

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect_right(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._total += 1

    def quantile(self, q: float) -> Optional[float]:
        """The ``q`` quantile, interpolated linearly inside its bucket (the
        first bucket's lower edge is 0); +inf past the last bound."""
        if self._total == 0:
            return None
        target = q * self._total
        cum = 0
        for i, count in enumerate(self._counts):
            if count and cum + count >= target:
                if i == len(self.buckets):
                    return float("inf")
                lo = self.buckets[i - 1] if i else 0.0
                return lo + (self.buckets[i] - lo) * max(0.0, target - cum) / count
            cum += count
        return float("inf")

    def merge(self, other: "Histogram") -> None:
        """Add the observations of ``other``, which has the same buckets."""
        if other.buckets != self.buckets:
            raise ValueError("histograms with different buckets")
        with other._lock:
            counts, total, sum_ = list(other._counts), other._total, other._sum
        with self._lock:
            self._counts = [a + b for a, b in zip(self._counts, counts)]
            self._total += total
            self._sum += sum_

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> float:
        return self._sum

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        cum = 0
        for bound, count in zip(self.buckets, self._counts):
            cum += count
            lines.append(f'{self.name}_bucket{{le="{bound}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._total}')
        lines.append(f"{self.name}_sum {self._sum}")
        lines.append(f"{self.name}_count {self._total}")
        return "\n".join(lines) + "\n"


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_, buckets))

    def get(self, name: str):
        """The metric named ``name``, or None: made by no one yet."""
        return self._metrics.get(name)

    def _get_or_create(self, name, factory):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = factory()
                self._metrics[name] = metric
            return metric

    def expose(self) -> str:
        return "".join(m.expose() for m in self._metrics.values())  # type: ignore[attr-defined]

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


registry = Registry()

_torch_profiler = None


def profiling() -> bool:
    """Whether ``torch.profiler`` records: started on this thread, or by
    ``torch.profiler.profile`` anywhere in the process."""
    global _torch_profiler
    if _torch_profiler is None:
        import torch
        import torch.autograd.profiler

        _torch_profiler = torch
    return (getattr(_torch_profiler.autograd.profiler, "_is_profiler_enabled", False)
            or _torch_profiler._C._autograd._profiler_enabled())


def _span_histogram(name: str, help_: str) -> Histogram:
    hist = registry.get(name)                   # a dict read: no lock once it exists
    return hist if hist is not None else registry.histogram(name, help_, SPAN_BUCKETS)


class span:
    """Time the body into the histogram ``<name>_ms``; while the profiler
    records, also as ``record_function("ics.<name>", "k=v ...")`` from the
    keyword arguments (a flush's lane, images or bucket), which are formatted
    only then. ``name`` is constant, so spans of one kind add up by name."""

    __slots__ = ("name", "args", "_t0", "_record")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args

    def __enter__(self) -> "span":
        self._record = None
        if profiling():
            self._record = _torch_profiler.profiler.record_function(
                f"ics.{self.name}", " ".join(f"{k}={v}" for k, v in self.args.items()) or None)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        ms = (time.perf_counter() - self._t0) * 1e3
        if self._record is not None:
            self._record.__exit__(*exc)
        _span_histogram(self.name + "_ms", "span (ms)").observe(ms)


def waited(name: str, since: float) -> None:
    """Observe into ``<name>_ms`` the time since ``since`` (``time.perf_counter``
    on the thread that handed the work over): called by the worker as it
    starts the work. A profiler range cannot cross threads, so a wait is a
    histogram only."""
    ms = (time.perf_counter() - since) * 1e3
    _span_histogram(name + "_ms", "queued for an executor thread (ms)").observe(ms)
