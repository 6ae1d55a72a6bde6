"""An open loop: requests sent on a schedule whatever the answers do.
Poisson arrivals at the traffic's ``rate_per_s``, each request timed from
the moment it was due, so a stall is charged to every request due behind
it. The gaps are the quantiles of the exponential law, shuffled by the
seed: every seed offers the same set of gaps in another order."""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Optional

from chipbench.load import Request, Window, arrival_offsets, call_at, finish, image_order, send


async def run(call: Callable, items: list, traffic: dict, seconds: float, seed: int,
              on_open: Optional[Callable[[float], Awaitable]] = None) -> Window:
    preroll = float(traffic["preroll_s"])
    offsets = arrival_offsets(float(traffic["rate_per_s"]), preroll + seconds, seed)
    order = image_order(len(items), len(offsets), seed)
    t0 = time.perf_counter()
    window = Window(start=t0 + preroll, end=t0 + preroll + seconds)
    hook = call_at(window.start, on_open)
    tasks = []
    for off, img in zip(offsets, order):
        due = t0 + float(off)
        if due >= window.end:
            break
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        req = Request(image=int(img), due=due)
        window.requests.append(req)
        tasks.append(asyncio.ensure_future(send(call, items[img], req)))
    await asyncio.sleep(max(0.0, window.end - time.perf_counter()))
    await finish(tasks, window.end)
    await hook
    return window
