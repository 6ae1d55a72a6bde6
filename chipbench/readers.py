"""What the per-layer metrics read from a traced run's record.

The record (``chipbench.run``) holds, for the traced window only:

- ``window_s``, ``busy_s``: its length and the union of device operations;
- ``answered``: answers that came inside it;
- ``counters``: the program's counters at its opening and close
  (``before``, ``after``): ``queued`` and ``flushes`` summed over every
  batcher of the service, ``queue_ms_sum`` and ``queue_ms_count`` of the
  ``batch_queue_ms`` histogram;
- ``kernels``: each device operation that started in it, with the flush
  span it was attributed to (``chipbench.trace.attribute``);
- ``config``: the cell's configuration.

A reader returns None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Callable, Optional

from chipbench import roofline


def delta(record: dict, key: str) -> float:
    return record["counters"]["after"][key] - record["counters"]["before"][key]


def ratio(record: dict, num: str, den: str) -> Optional[float]:
    d = delta(record, den)
    return delta(record, num) / d if d > 0 else None


def idle_percent(record: dict) -> Optional[float]:
    if record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def device_ms_per_image(record: dict) -> Optional[float]:
    if record["answered"] <= 0:
        return None
    return record["busy_s"] * 1e3 / record["answered"]


def mfu_percent(record: dict) -> Optional[float]:
    """Model FLOPs of the answered images over the window, as a share of the
    bf16 dense peak (989 TFLOP/s, 700 W)."""
    if record["answered"] <= 0 or record["window_s"] <= 0:
        return None
    flops = record["answered"] * roofline.model_flops(record["config"])
    return 100.0 * flops / record["window_s"] / roofline.BF16_FLOPS


def roofline_percent(record: dict, needle: str, per_flush: int,
                     work: Callable[[int, int], tuple]) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their device times, over
    the flushes whose ``per_flush`` launches of kernels named with
    ``needle`` all ran in the window; ``work(bucket, i)`` gives the i-th
    launch's (bytes, operations)."""
    by_span: dict[int, list] = {}
    for k, span in record["kernels"]:
        if needle in k.name and span is not None:
            by_span.setdefault(id(span), [span]).append(k)
    bound_ms = time_ms = 0.0
    for span, *launches in by_span.values():
        if len(launches) != per_flush:
            continue                         # cut by the window's edge
        launches.sort(key=lambda k: k.start)
        for i, k in enumerate(launches):
            bound_ms += roofline.bound(*work(span.bucket, i))["bound_ms"]
            time_ms += (k.end - k.start) / 1e6
    return 100.0 * bound_ms / time_ms if time_ms > 0 else None


def chain_work(config: dict) -> tuple[int, Callable[[int, int], tuple]]:
    """Launches a step and the work of the i-th: one launch a chained
    bottleneck, stage by stage (``config["chains"]``)."""
    stages = [c for c in config["chains"] for _ in range(c["launches"])]

    def work(bucket: int, i: int) -> tuple:
        c = stages[i]
        return roofline.chain_launch_work(bucket, c["height"], c["width"], c["channels"],
                                          c["inner"])
    return len(stages), work


def flash_work(config: dict) -> tuple[int, Callable[[int, int], tuple]]:
    tokens = (config["image_size"] // config["patch_size"]) ** 2 + 1
    hd = config["hidden_size"] // config["heads"]
    return config["layers"], lambda bucket, i: roofline.flash_work(
        bucket, config["heads"], tokens, hd)
