"""One run of one benchmark cell of ``ics_tpu_torch`` on the card.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json`` and its configuration, traffic and
limits from ``chipbench/{configs,traffic,limits}/``; sets the system up
through the entry that the traffic names (``chipbench/entries/<entry>.py``:
inputs and weights from the seed, the program built and warmed for this
traffic); offers the load for a pre-roll and then for the window; has the
entry check the answers against the plain reference; and prints one JSON
line last on standard output. With ``--trace 0`` its metrics are the
cell's end-to-end metrics; with ``--trace 1`` the profiler records the
first ``TRACE_S`` seconds of the window and the metrics are the cell's
per-layer ones. Each metric is read by ``chipbench/metrics/<name>.py``.

Exits with code 2 and prints no result where there is no CUDA card or too
few, and with 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench import manifest, roofline, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ics_tpu")
TRACE_S = 3.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``ics_tpu_torch`` is not ``ics_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def prepare(config: dict) -> None:
    """The configuration's ``TPU_*`` settings, and TF32 off."""
    os.environ.update(config["settings"])
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


async def serve(session, seconds: float, seed: int, traced: bool) -> dict:
    """Warm, pre-roll, window; the traced window's record where ``traced``."""
    await session.start()
    out: dict = {}
    tracer = probe = None
    if traced:
        probe = session.probe()
        tracer = trace.DeviceTrace()
        tracer.start()
    trace_s = min(seconds, TRACE_S)

    async def on_open(at: float) -> None:
        if not traced:
            return
        out["trace"] = {"before": session.counters(), "t0": tracer.marker("chipbench.window"),
                        "p0": time.perf_counter()}
        await asyncio.sleep(max(0.0, at + trace_s - time.perf_counter()))
        rec = out["trace"]
        rec["t1"] = tracer.marker("chipbench.window_end")
        rec["p1"] = time.perf_counter()
        rec["after"] = session.counters()
        rec["events"] = tracer.stop()
        probe.remove()

    pauses: list = []                   # the interpreter's full collections, to read stalls by

    def on_gc(phase: str, info: dict) -> None:
        if info["generation"] == 2:
            pauses.append(time.perf_counter())

    gc.callbacks.append(on_gc)
    try:
        out["window"] = await session.drive(seconds, seed, on_open=on_open)
    finally:
        gc.callbacks.remove(on_gc)
    w = out["window"]
    spans = [(round(a - w.start, 2), round((b - a) * 1e3, 1))
             for a, b in zip(pauses[::2], pauses[1::2]) if w.start <= a < w.end]
    log(f"gc: full collections in the window (s into it, ms): {spans}")
    log(f"status: {session.status()}")
    if probe is not None:
        out["spans"] = probe.spans
    await session.stop()
    return out


def traced_record(out: dict, config: dict) -> tuple[dict, dict, dict]:
    """(the readers' record, the device's busy and window seconds, breakdown)."""
    rec = out["trace"]
    lo, hi = rec["t0"], rec["t1"]
    events: list[trace.Event] = rec["events"]
    device = [e for e in events if e.device]
    host = [e for e in events if not e.device and not e.name.startswith("chipbench.")]
    api = {e.correlation: e for e in host if trace.is_cuda_call(e.name)}
    kernels = [e for e in device if lo <= e.start < hi]
    spans = out.get("spans", [])
    owners = trace.attribute(kernels, api, [s for s in spans if s.bucket])   # the flushes' spans
    window = out["window"]
    answered = sum(1 for r in window.requests if r.ok and rec["p0"] <= r.done < rec["p1"])
    busy = trace.busy_ns([(e.start, e.end) for e in device], lo, hi) / 1e9
    window_s = (hi - lo) / 1e9
    record = {"window_s": window_s, "busy_s": busy, "answered": answered,
              "counters": {"before": rec["before"], "after": rec["after"]},
              "kernels": list(zip(kernels, owners)), "config": config}
    attributed = sum(1 for o in owners if o is not None)
    log(f"trace: {len(events)} events, {len(device)} on the device, {len(kernels)} in the "
        f"window of {window_s:.3f} s, {attributed} attributed to a flush; busy {busy:.4f} s")
    for group, s in trace.group_totals(device, lo, hi, roofline.group_of).items():
        log(f"trace: {group} {s:.6f} s")
    brk = trace.breakdown(device, host + spans, lo, hi, roofline.group_of)
    return record, {"busy_s": busy, "window_s": window_s}, brk


def verdict(checks: dict) -> bool:
    """``correct``: every check that has a limit is within it."""
    return all(c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None)


def run_cell(cell: dict, config: dict, traffic: dict, limits: dict, bench: dict, seed: int,
             seconds: float, traced: bool, device: str = "cuda",
             on_service: Optional[Callable] = None, control: bool = False,
             record: bool = False) -> dict:
    """One run; returns the result's fields and the checks, and with
    ``control`` the control's verdict and checks under ``control``."""
    prepare(config)
    import torch

    on_card = device != "cpu"
    card = card_power_limit() if on_card else "cpu"
    log(f"card: {card}; cell {cell['name']} seed {seed} seconds {seconds} trace {int(traced)}")
    session = manifest.entry(traffic["entry"]).Session(config, traffic, seed, device,
                                                       warm_all=traced, hook=on_service)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = asyncio.run(serve(session, seconds, seed, traced))
    window = out["window"]
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    metrics: dict = {}
    if traced:
        layer_record, dev_times, brk = traced_record(out, config)
        wanted = manifest.metrics_for(cell["name"], bench, "per_layer")
    else:
        layer_record, dev_times, brk = {"window": window, "started": T_START,
                                        "reference_s": session.reference_s}, {}, None
        wanted = manifest.metrics_for(cell["name"], bench, "end_to_end")
    for m in wanted:
        value = manifest.reader(m["name"]).read(layer_record)
        if value is not None:           # a percentile that missing answers make +inf: 1e12
            metrics[m["name"]] = {"value": min(value, 1e12), "unit": m["unit"]}
    in_window = window.in_window()
    lateness = [r.sent - r.due for r in in_window if not math.isnan(r.sent)]
    log(f"window: {len(in_window)} requests, {sum(1 for r in in_window if r.ok)} answered, "
        f"setup {window.start - T_START:.3f} s of which the reference {session.reference_s:.3f} s, "
        f"peak {peak} bytes, generator late by at most {max(lateness, default=0.0) * 1e3:.3f} ms")
    log(session.describe(window))
    del out
    session.close()
    checks, control_checks = session.check(limits, window, control=control, record=record)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak, **dev_times}
    result = {"correct": verdict(checks), "attempted": len(in_window),
              "failed": sum(1 for r in in_window if not r.ok), "metrics": metrics,
              "device": device_info, **({"breakdown": brk} if traced else {}), "card": card}
    if control_checks is not None:
        result["control"] = {"correct": verdict(control_checks), "checks": control_checks}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = manifest.benchmark()
    cell = manifest.cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no result: the cell needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    result = run_cell(cell, manifest.config(cell["config"]), manifest.traffic(cell["traffic"]),
                      manifest.limits(cell["name"]), bench, args.seed, args.seconds,
                      bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        log(f"no result: the process loaded {', '.join(loaded)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
