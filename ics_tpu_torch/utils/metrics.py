"""Lightweight metrics registry with Prometheus text exposition.

Counters, gauges and fixed-bucket histograms; zero dependencies, safe from
both the event loop and worker threads. Feeds the BASELINE observability
metrics (img/s, batch occupancy, p50/p99) via ``/monitor/metrics``.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Optional, Sequence

_DEFAULT_BUCKETS = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
)


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
        if self._total == 0:
            return None
        target = q * self._total
        cum = 0
        for i, count in enumerate(self._counts):
            cum += count
            if cum >= target:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

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
