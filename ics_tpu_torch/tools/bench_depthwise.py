"""The depthwise-convolution kernel beside cuDNN at a model's own shapes.

    python -m ics_tpu_torch.tools.bench_depthwise --model efficientnet_b4 [--bucket 32]

Collects every depthwise convolution the kernel takes in one forward of
``--model`` at ``--bucket`` images (shapes only, on the meta device), then
for each distinct (shape, k, bias) in bf16 on the GPU: the kernel's and
cuDNN's grouped convolution's time by CUDA events, with the launches queued
ahead of the device so that a short kernel is timed on the device's clock,
and the host's time per call of each (the wrapper against ``F.conv2d``),
which is what a host-bound step pays, beside the least time the card could
take for the shape (input read once and output written once at 3.35 TB/s,
or 2 k^2 fp32 operations an output at 67 TFLOP/s, whichever is longer). The
card's name and power limit come first; one JSON line at the end carries the
same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import torch
import torch.nn.functional as F

from ics_tpu_torch.models.registry import get_model
from ics_tpu_torch.nn.layers import Conv2D
from ics_tpu_torch.ops.depthwise import depthwise_conv
from ics_tpu_torch.tools.profile_step import events_ms


def depthwise_calls(model_name: str, bucket: int) -> Counter:
    """{(input shape, k, has bias): launches} of one folded forward."""
    spec = get_model(model_name)
    model = spec.build(num_classes=1000, device="meta").fold()
    calls: Counter = Counter()

    def record(module, args):
        k = module.weight.shape[-1]
        calls[(tuple(args[0].shape), k, module.bias is not None)] += 1

    for module in model.modules():
        if isinstance(module, Conv2D) and module.depthwise:
            module.register_forward_pre_hook(record)
    x = torch.empty((bucket, spec.image_size, spec.image_size, 3), device="meta")
    with torch.inference_mode():
        model.apply_folded(x)
    return calls


def queued_ms(fn, ahead: torch.Tensor, iters: int) -> float:
    """ms per call on the device's clock: two large products go first, so
    every launch is queued by the time the first one starts."""
    for _ in range(2):
        torch.mm(ahead, ahead)
    return events_ms(fn, iters)


def host_us(fn, calls: int = 1000) -> float:
    """The host's time per call, launches only (the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


HBM_BYTES_S = 3.35e12     # published peaks of one H100 SXM
FP32_FLOPS = 67e12


def bound_ms(n_values: int, k: int, channels: int, bias: bool) -> tuple[float, str]:
    """The least time the card could take for one bf16 call, and what bounds it."""
    by_bytes = (2 * n_values + (k * k + bias) * channels) * 2 / HBM_BYTES_S * 1e3
    by_ops = 2.0 * k * k * n_values / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="efficientnet_b4")
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    g = torch.Generator().manual_seed(0)
    ahead = torch.ones((8192, 8192), device="cuda", dtype=torch.bfloat16)
    rows = []
    for (shape, k, bias), count in sorted(depthwise_calls(args.model, args.bucket).items()):
        c = shape[-1]
        x = torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
        w = (torch.randn((c, 1, k, k), generator=g) / k).to(torch.bfloat16).cuda()
        w = w.contiguous(memory_format=torch.channels_last)      # as fold() stores it
        b = torch.randn(c, generator=g).to(torch.bfloat16).cuda() if bias else None
        x_nchw = x.permute(0, 3, 1, 2)
        kernel = lambda: depthwise_conv(x, w, b)  # noqa: E731
        cudnn = lambda: F.conv2d(x_nchw, w, b, 1, k // 2, 1, c)  # noqa: E731
        for fn in (kernel, cudnn):
            events_ms(fn, 3)
        ms = {"kernel": [], "cudnn": []}
        for name in ("kernel", "cudnn", "cudnn", "kernel"):
            ms[name].append(queued_ms(kernel if name == "kernel" else cudnn, ahead, args.iters))
        least, by = bound_ms(x.numel(), k, c, bias)
        row = {"shape": list(shape), "k": k, "bias": bias, "launches": count,
               "kernel_ms": sum(ms["kernel"]) / 2, "cudnn_ms": sum(ms["cudnn"]) / 2,
               "bound_ms": least, "bound_by": by,
               "kernel_host_us": host_us(kernel), "cudnn_host_us": host_us(cudnn)}
        rows.append(row)
        print(f"{list(shape)} k={k} bias={bias} x{count}: kernel {row['kernel_ms']:.4f} ms, "
              f"cuDNN {row['cudnn_ms']:.4f} ms, bound {least:.4f} ms by {by}; host "
              f"{row['kernel_host_us']:.1f} vs {row['cudnn_host_us']:.1f} us a call")
    total = {key: sum(r[key] * r["launches"] for r in rows)
             for key in ("kernel_ms", "cudnn_ms", "bound_ms")}
    print(f"{args.model} bucket {args.bucket}: {sum(r['launches'] for r in rows)} launches a "
          f"step, kernel {total['kernel_ms']:.4f} ms, cuDNN {total['cudnn_ms']:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms")
    print(json.dumps({"card": card, "model": args.model, "bucket": args.bucket,
                      "step": total, "shapes": rows}))


if __name__ == "__main__":
    main()
