"""The knee of an open-loop cell: the highest offered rate at which the 95th
percentile stays within the latency limit and the requests in flight do
not grow over the window. Run once, when the cell is defined; the cell's
traffic file then holds a fixed rate below the knee. Not part of a
benchmark run.

    python3 chipbench/sweep.py --workload resnet50.label-open --seconds 8 \\
        --rates 100 150 200 250 300 [--limit-ms 100]

One session is set up as the timed cell's is (``run.prepare`` and the
entry's ``Session``), then each rate is offered in turn, from the lowest. Prints one JSON line a rate: p50 and p95 over the window's
requests, the answers a second, the median latency of the window's first
and last quarters (a queue that grows shows as a rising last quarter), and
whether the rate is within the limit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench import load, manifest, run  # noqa: E402

GROWTH = 1.5    # last quarter's median over the first's, past which the queue grows


def quarter_medians(window: load.Window) -> tuple[float, float]:
    reqs = sorted(window.in_window(), key=lambda r: r.due)
    q = max(1, len(reqs) // 4)
    lat = lambda rs: load.percentile([(r.done - r.due) * 1e3 if r.ok else float("inf")  # noqa: E731
                                      for r in rs], 50)
    return lat(reqs[:q]), lat(reqs[-q:])


async def sweep(session, traffic, seconds, seed, rates, limit_ms) -> list:
    await session.start()
    rows = []
    for rate in rates:
        window = await session.drive(seconds, seed, traffic=dict(traffic, rate_per_s=rate))
        lat = load.latencies_ms(window)
        first, last = quarter_medians(window)
        p95 = load.percentile(lat, 95)
        row = {"rate_per_s": rate, "p50_ms": load.percentile(lat, 50), "p95_ms": p95,
               "answers_per_s": load.completed_per_s(window), "requests": len(lat),
               "first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
               "within": bool(p95 <= limit_ms and last <= GROWTH * max(first, 1e-9))}
        rows.append(row)
        print(json.dumps(row), flush=True)
        await asyncio.sleep(2.0)                       # drain before the next rate
    await session.stop()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=20261018)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--limit-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    cell = manifest.cell(args.workload)
    config, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    run.prepare(config)
    print(run.card_power_limit(), flush=True)
    # the timed cell's own set-up, warmed at every bucket: the higher rates fill them all
    session = manifest.entry(traffic["entry"]).Session(config, traffic, args.seed, "cuda",
                                                       warm_all=True)
    rows = asyncio.run(sweep(session, traffic, args.seconds, args.seed, sorted(args.rates),
                             args.limit_ms))
    knee = None
    for r in rows:                     # the highest rate before the first one past the limit
        if not r["within"]:
            break
        knee = r["rate_per_s"]
    print(json.dumps({"knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
