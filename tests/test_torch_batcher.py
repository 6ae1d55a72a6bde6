"""The port's dynamic batcher: a request put in the queue while the
flusher's short poll times out joins the batch being collected.

Under load the poll's timeout and the last announced request's ``put`` can
land in one tick of the event loop: the item is then queued, its
announcement already retracted, and the flusher reads ``_incoming == 0``.
The batch must still take it.
"""

import asyncio

import numpy as np
import pytest

from ics_tpu_torch.runtime import batcher as batcher_mod
from ics_tpu_torch.runtime.batcher import DynamicBatcher


def make_batcher(max_batch=4, deadline_us=50_000):
    def stage(images):
        return np.stack(images), None

    def predict(canvas, _):
        n = len(canvas)
        return np.arange(n)[:, None], canvas.reshape(n, -1)[:, :1].astype(np.float32)

    return DynamicBatcher(predict_staged=predict, stage_batch=stage, max_batch=max_batch,
                          deadline_us=deadline_us, max_deadline_us=deadline_us)


@pytest.mark.anyio
@pytest.mark.parametrize("late", [1, 2])
async def test_a_request_put_as_the_poll_times_out_joins_the_batch(monkeypatch, late):
    b = make_batcher()
    real_wait_for = asyncio.wait_for
    state = {"armed": True}
    late_futures = []

    async def racing_wait_for(aw, timeout):
        # the first short poll: the last announced requests are put and
        # retracted in the same tick as the poll's timeout
        if state["armed"] and b._incoming == late:
            state["armed"] = False
            aw.close()
            for i in range(late):
                late_futures.append(asyncio.ensure_future(
                    b.submit(np.full((2, 2), 10 + i, np.uint8), announced=True)))
            await asyncio.sleep(0)          # the puts and retracts run now
            raise asyncio.TimeoutError
        return await real_wait_for(aw, timeout)

    monkeypatch.setattr(batcher_mod.asyncio, "wait_for", racing_wait_for)
    await b.start()
    try:
        for _ in range(4):
            b.announce()
        futures = [asyncio.ensure_future(b.submit(np.full((2, 2), i, np.uint8), announced=True))
                   for i in range(4 - late)]
        await asyncio.sleep(0)
        outs = await real_wait_for(asyncio.gather(*futures), 5)
        outs += await real_wait_for(asyncio.gather(*late_futures), 5)
        assert len(outs) == 4 and not state["armed"]
        assert b.stats["flushes"] == 1 and b.stats["max_batch_seen"] == 4
        assert b._incoming == 0
    finally:
        await b.stop()


@pytest.mark.anyio
async def test_without_announcements_the_deadline_alone_closes_the_batch():
    b = make_batcher(deadline_us=2_000)
    await b.start()
    try:
        idx, _ = await b.submit(np.zeros((2, 2), np.uint8))
        assert int(idx[0]) == 0 and b.stats["flushes"] == 1
    finally:
        await b.stop()
