"""A closed loop: the traffic's ``clients`` requests kept outstanding, each
client sending its next item when its last one is answered; a request is
timed from when it was sent."""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Optional

from chipbench.load import Request, Window, call_at, finish, image_order, send


async def run(call: Callable, items: list, traffic: dict, seconds: float, seed: int,
              on_open: Optional[Callable[[float], Awaitable]] = None) -> Window:
    preroll = float(traffic["preroll_s"])
    clients = int(traffic["clients"])
    order = image_order(len(items), len(items) * 4096, seed)
    cursor = iter(order.tolist())
    t0 = time.perf_counter()
    window = Window(start=t0 + preroll, end=t0 + preroll + seconds)

    async def client() -> None:
        while True:
            now = time.perf_counter()
            if now >= window.end:
                return
            req = Request(image=next(cursor), due=now)
            window.requests.append(req)
            await send(call, items[req.image], req)

    hook = call_at(window.start, on_open)
    tasks = [asyncio.ensure_future(client()) for _ in range(clients)]
    await asyncio.sleep(max(0.0, window.end - time.perf_counter()))
    await finish(tasks, window.end)
    await hook
    return window
