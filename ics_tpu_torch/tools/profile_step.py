"""Where one engine step's time goes on the GPU.

    python -m ics_tpu_torch.tools.profile_step --model resnet50 --bucket 32 [--fused-chains]
    python -m ics_tpu_torch.tools.profile_step --model convnext_tiny [--no-kernels]

    python -m ics_tpu_torch.tools.profile_step --model mobilenetv3_small --in-turns 6 [--off-first]

``--model`` takes any name of the port's registry. ``--no-kernels`` sends the
depthwise convolutions to cuDNN and Swin's window attention to its plain
version, to see the same step without the hand-written kernels.
``--in-turns N`` builds two engines in one process, kernels on and kernels
off (``--off-first``: in the other order), and times them N times in turns:
the step by CUDA events and the host's time to queue a step, which is the
step's time wherever the device waits for the host.

Builds the engine with random weights from seed 0, stages random images of
300-512 px (or ``--exact``: all exactly the model's input size, the
fixed-size lane) on a 512 canvas, and prints: the card's name and power
limit; the step's time by CUDA events (whole step, preprocess alone); then
``torch.profiler``'s device time by kernel over ``--steps`` steps (the
``--top`` longest listed by name), grouped
into convolution/GEMM, the port's own kernels, and elementwise glue, with
the device's busy share of the profiled wall time. One JSON line at the end
carries the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from ics_tpu_torch.nn.layers import set_use_kernels
from ics_tpu_torch.ops import launch_counts, reset_launch_counts
from ics_tpu_torch.ops.preproc import preprocess_batch
from ics_tpu_torch.runtime.engine import InferenceEngine

GROUPS = (
    # every __global__ of ops/csrc (tests/test_torch_standalone.py holds the two in line)
    ("port kernels", ("flash_wgmma", "flash_mma", "flash_f32", "bottleneck_wgmma",
                      "normalize_vec", "normalize_scalar", "dw_strip", "dw_tile", "dw_direct",
                      "window_bf16", "window_f32", "window_bwd", "dw_grad", "table_sum",
                      "table_gather")),
    ("convolution and GEMM", ("gemm", "cutlass", "nvjet", "xmma", "conv", "cudnn", "wgrad",
                              "implicit", "sm90_", "sm80_")),
    ("pooling, softmax, top-k", ("pool", "softmax", "topk", "sort", "gather", "reduce")),
)


def group_of(kernel_name: str) -> str:
    lowered = kernel_name.lower()
    for group, needles in GROUPS:
        if any(n in lowered for n in needles):
            return group
    return "elementwise glue and copies"


def events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """The host's time to queue one call (the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def in_turns(args, card: str) -> None:
    """Kernels on and off in one process, ``args.in_turns`` times in turns."""
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (args.bucket, args.canvas, args.canvas, 3), np.uint8)
    sizes = rng.integers(300, args.canvas + 1, (args.bucket, 2)).astype(np.int32)
    steps = {}
    for name in ("off", "on") if args.off_first else ("on", "off"):
        eng = InferenceEngine(args.model, precision="bf16", buckets=(args.bucket,),
                              canvas=args.canvas, fused_chains=args.fused_chains)
        set_use_kernels(eng.model, name == "on")
        staged = eng._to_device(canvas, sizes)
        steps[name] = (lambda e, s: lambda: e._step(*s))(eng, staged)
        events_ms(steps[name], 3)
    rounds = {name: [] for name in steps}
    for _ in range(args.in_turns):
        for name, step in steps.items():
            rounds[name].append((events_ms(step, 20), host_ms(step, 20)))
    for name, values in rounds.items():
        print(f"{args.model} kernels {name}: step by events "
              f"{[round(e, 2) for e, _ in values]} ms, host to queue a step "
              f"{[round(h, 2) for _, h in values]} ms")
    print(json.dumps({"card": card, "model": args.model, "bucket": args.bucket,
                      "order": list(steps), "python_threads": threading.active_count(),
                      "event_ms": {n: [e for e, _ in v] for n, v in rounds.items()},
                      "host_ms": {n: [h for _, h in v] for n, v in rounds.items()}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--canvas", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fused-chains", action="store_true")
    ap.add_argument("--no-kernels", action="store_true",
                    help="depthwise convolutions by cuDNN, window attention by its plain version")
    ap.add_argument("--exact", action="store_true",
                    help="every image exactly the model's input size (fixed-size lane)")
    ap.add_argument("--in-turns", type=int, default=0,
                    help="two engines, kernels on and off, timed this many times in turns")
    ap.add_argument("--off-first", action="store_true",
                    help="with --in-turns: build and time the kernels-off engine first")
    ap.add_argument("--top", type=int, default=12, help="kernels to list by device time")
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    if args.in_turns:
        in_turns(args, card)
        return
    eng = InferenceEngine(args.model, precision="bf16", buckets=(args.bucket,),
                          canvas=args.canvas, fused_chains=args.fused_chains)
    set_use_kernels(eng.model, not args.no_kernels)
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (args.bucket, args.canvas, args.canvas, 3), np.uint8)
    if args.exact:
        sizes = np.full((args.bucket, 2), eng.spec.image_size, np.int32)
    else:
        sizes = rng.integers(300, args.canvas + 1, (args.bucket, 2)).astype(np.int32)
    fixed = eng._fixed_size(canvas, sizes)
    staged = eng._to_device(canvas, sizes)
    step = lambda: eng._step(*staged, fixed_size=fixed)  # noqa: E731
    pre = lambda: preprocess_batch(  # noqa: E731
        *staged, out_size=eng.spec.image_size, resize_short=eng.spec.resize_short,
        dtype=eng.dtype)
    for fn in (step, pre):
        events_ms(fn, 3)
    reset_launch_counts()
    step()
    per_step = launch_counts()
    step_ms = events_ms(step, 20)
    pre_ms = None if fixed else events_ms(pre, 20)
    print(f"{args.model} bf16 bucket {args.bucket} fused_chains={eng.fused_chains} "
          f"kernels={not args.no_kernels} fixed_size={fixed}: step {step_ms:.3f} ms ({args.bucket / step_ms * 1e3:.0f} "
          f"images/s), preprocess alone {pre_ms if pre_ms is None else round(pre_ms, 3)} ms, "
          f"kernel launches per step {per_step}")

    prof = profile_steps(step, args.steps)
    by_group, busy_ms = prof["device_ms_by_group"], prof["device_busy_ms"]
    if busy_ms == 0:
        print("torch.profiler recorded no device time here; only the event times above hold")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:32s} {ms:8.3f} ms/step  {ms / busy_ms:6.1%}")
    for ms, count, key in prof["by_kernel"][:args.top]:
        print(f"    {ms:8.3f} ms/step  x{count:<4d} {key[:100]}")
    print(f"  device busy {busy_ms:.3f} ms/step of {prof['wall_ms']:.3f} ms wall "
          f"({prof['device_busy_share']:.1%}; profiler on), {prof['kernels_per_step']} "
          "kernels a step")
    print(json.dumps({
        "card": card, "model": args.model, "bucket": args.bucket,
        "fused_chains": eng.fused_chains, "kernels": not args.no_kernels,
        "fixed_size": fixed, "step_ms": step_ms,
        "preprocess_ms": pre_ms, "launches_per_step": per_step,
        **{k: v for k, v in prof.items() if k != "by_kernel"},
    }))


def _on_device(ev) -> bool:
    return getattr(ev, "device_type", None) is not None and str(ev.device_type).endswith("CUDA")


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_steps(step, steps: int) -> dict:
    """``steps`` calls of ``step`` (an engine step returning (idx, scores))
    under ``torch.profiler``, each ending in a fetch as the served step does:
    the device time a step by group and by kernel (ms, launches, name; the
    longest first), the device's busy time (the union of the kernels'
    intervals) and its share of the profiled wall time (profiler on), and
    the kernels a step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            idx, _ = step()
            idx.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group: dict[str, float] = defaultdict(float)
    by_kernel = []
    n_kernels = 0
    for ev in prof.key_averages():
        device_us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if not _on_device(ev) or device_us <= 0:
            continue
        by_group[group_of(ev.key)] += device_us / 1e3 / steps
        by_kernel.append((device_us / 1e3 / steps, ev.count // steps, ev.key))
        n_kernels += ev.count
    # the device is busy where any kernel runs: overlapping kernels count once
    busy_ms = union_length([(ev.time_range.start, ev.time_range.end)
                            for ev in prof.events() if _on_device(ev)]) / 1e3 / steps
    return {"device_ms_by_group": dict(by_group), "by_kernel": sorted(by_kernel, reverse=True),
            "device_busy_ms": busy_ms, "wall_ms": wall_ms / steps,
            "device_busy_share": busy_ms * steps / wall_ms, "kernels_per_step": n_kernels // steps}


if __name__ == "__main__":
    main()
