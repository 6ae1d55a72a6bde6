"""Arrivals and clients: the load half of every traffic mix, and the
client-side clock that times each request.

Each kind of loop is a module of its own, ``loops/<name>.py``, found by
the traffic file's ``loop`` key: ``open`` (a schedule of arrivals) and
``closed`` (clients that wait for their answers). Every loop starts
``preroll_s`` before the window, so the window opens on a system that
already carries the load; only the window's requests count. Items are
taken in seeded permutations of the run's distinct items, one after
another.
"""

from __future__ import annotations

import asyncio
import importlib
import math
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Awaitable, Callable, Optional

import numpy as np

# how long after the window's close an answer may still come before it
# counts as never come
LATE_S = 60.0


@dataclass
class Request:
    image: int
    due: float                        # perf_counter when it was due (open) or sent (closed)
    sent: float = math.nan
    done: float = math.nan
    answer: Any = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and not math.isnan(self.done)


@dataclass
class Window:
    start: float                      # perf_counter at the window's opening
    end: float
    requests: list = field(default_factory=list)

    def in_window(self) -> list:
        """Open loop: the requests due in the window. Closed loop: those
        sent in it."""
        return [r for r in self.requests if self.start <= r.due < self.end]


def image_order(n_images: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 23])
    reps = -(-n // n_images)
    return np.concatenate([rng.permutation(n_images) for _ in range(reps)])[:n]


def arrival_offsets(rate: float, duration_s: float, seed: int) -> np.ndarray:
    """Due times in seconds from the start of the pre-roll, over
    ``duration_s``: the exponential gaps' quantiles in a seeded order."""
    n = max(1, round(rate * duration_s))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[np.random.default_rng([seed, 29]).permutation(n)]
    return np.cumsum(gaps) - gaps[0]


async def send(call: Callable[[Any], Awaitable], item: Any, req: Request) -> None:
    req.sent = time.perf_counter()
    try:
        req.answer = await call(item)
        req.done = time.perf_counter()
    except Exception as exc:                        # a failed request is a missing answer
        req.error = f"{type(exc).__name__}: {exc}"


def call_at(when: float, fn: Optional[Callable[[float], Awaitable]]) -> asyncio.Future:
    """Run the coroutine ``fn(when)`` at perf_counter ``when``, beside the load."""
    async def later() -> None:
        if fn is not None:
            await asyncio.sleep(max(0.0, when - time.perf_counter()))
            await fn(when)
    return asyncio.ensure_future(later())


async def finish(tasks: list, end: float) -> None:
    pending = [t for t in tasks if not t.done()]
    if pending:
        await asyncio.wait(pending, timeout=max(0.0, end + LATE_S - time.perf_counter()))
    for t in tasks:
        if not t.done():
            t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


def loop(name: str) -> ModuleType:
    """The loop kind ``loops/<name>.py``: its ``run(call, items, traffic,
    seconds, seed, on_open)`` offers ``items`` to the awaitable ``call``
    and returns the Window."""
    return importlib.import_module(f"chipbench.loops.{name}")


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, as numpy's default; a missing answer is +inf."""
    if not values:
        return math.inf
    arr = np.sort(np.asarray(values, dtype=np.float64))
    pos = (len(arr) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(arr[hi]):
        return math.inf
    return float(arr[lo] + (arr[hi] - arr[lo]) * (pos - lo))


def latencies_ms(window: Window) -> list[float]:
    """Each request of the window, from when it was due to its answer; a
    request that failed or never came counts as +inf."""
    return [(r.done - r.due) * 1e3 if r.ok else math.inf for r in window.in_window()]


def completed_per_s(window: Window) -> float:
    """Answers that came inside the window, over the window's seconds."""
    n = sum(1 for r in window.requests if r.ok and window.start <= r.done < window.end)
    return n / (window.end - window.start)
