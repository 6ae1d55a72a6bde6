"""The depthwise-convolution kernels beside cuDNN at the models' own shapes.

    python -m ics_tpu_torch.tools.bench_depthwise [--model efficientnet_b4 ...] [--bucket 32 ...]

Collects every depthwise convolution the kernel takes in one forward of each
``--model`` (default: EfficientNet-B4 with its k 3 and 5, MobileNetV3-Small,
ConvNeXt-T with its k 7) at ``--bucket`` images (shapes only, on the meta
device), then for each distinct (shape, k, bias) in bf16 on the GPU, in
turns: the kernel that serves the shape through the ``Conv2D`` module, the
strip kernel with its wide and with its narrow thread shape and the tile
kernel each on its own, and cuDNN's grouped convolution,
by CUDA events with the launches queued ahead of the device so that a short
kernel is timed on the device's clock; the host's time per call of the
module with the kernel and with cuDNN, which is what a host-bound step pays;
and the least time the card could take for the shape (input read once and
output written once at 3.35 TB/s, or 2 k^2 fp32 operations an output at 67
TFLOP/s, whichever is longer). The card's name and power limit come first;
one JSON line a model carries the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import torch

from ics_tpu_torch.models.registry import get_model
from ics_tpu_torch.nn.layers import Conv2D
from ics_tpu_torch.ops.depthwise import (
    STRIP_SHAPES,
    depthwise_conv,
    kernel_taps,
    pick_plan,
    strip_geometry,
)
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


def served_by(shape, k: int) -> str:
    """The kernel that ``pick_plan`` gives a bf16 call, with the strip
    kernel's thread shape."""
    variant, geometry = pick_plan(*shape, k, 2)
    if variant != "strip":
        return variant
    return "wide" if geometry[:2] == STRIP_SHAPES[(2, k)][0] else "narrow"


def bench_model(model: str, bucket: int, iters: int, card: str, ahead: torch.Tensor) -> dict:
    g = torch.Generator().manual_seed(0)
    rows = []
    for (shape, k, bias), count in sorted(depthwise_calls(model, bucket).items()):
        c = shape[-1]
        x = torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
        conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
        conv.reset_parameters(g)
        conv = conv.to(device="cuda", dtype=torch.bfloat16,
                       memory_format=torch.channels_last)      # as fold() stores it
        cudnn_conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
        cudnn_conv.load_state_dict(conv.state_dict())
        cudnn_conv = cudnn_conv.to(device="cuda", dtype=torch.bfloat16,
                                   memory_format=torch.channels_last)
        cudnn_conv.use_kernel = False
        # the taps as [k, k, C], which the wrapper takes without a copy
        w = kernel_taps(conv.weight.detach(), c).reshape(k, k, c)
        b = None if conv.bias is None else conv.bias.detach()
        wide, narrow = (strip_geometry(*shape, k, 2, ch, cols)
                        for ch, cols in STRIP_SHAPES[(2, k)])
        fns = {
            "kernel": lambda: conv(x),
            "wide": lambda: depthwise_conv(x, w, b, variant="strip", geometry=wide),
            "narrow": lambda: depthwise_conv(x, w, b, variant="strip", geometry=narrow),
            "tile": lambda: depthwise_conv(x, w, b, variant="tile"),
            "cudnn": lambda: cudnn_conv(x),
        }
        ms = {name: [] for name in fns}
        with torch.inference_mode():
            for fn in fns.values():
                events_ms(fn, 3)
            for name in (*fns, *reversed(fns)):
                ms[name].append(queued_ms(fns[name], ahead, iters))
            hosts = {name: host_us(fns[name]) for name in ("kernel", "cudnn")}
        least, by = bound_ms(x.numel(), k, c, bias)
        row = {"shape": list(shape), "k": k, "bias": bias, "launches": count,
               "served_by": served_by(shape, k),
               **{f"{name}_ms": sum(v) / len(v) for name, v in ms.items()},
               "bound_ms": least, "bound_by": by,
               "kernel_host_us": hosts["kernel"], "cudnn_host_us": hosts["cudnn"]}
        rows.append(row)
        print(f"{list(shape)} k={k} bias={bias} x{count}: kernel ({row['served_by']}) "
              f"{row['kernel_ms']:.4f} ms, wide {row['wide_ms']:.4f}, narrow "
              f"{row['narrow_ms']:.4f}, tile {row['tile_ms']:.4f}, cuDNN {row['cudnn_ms']:.4f}, "
              f"bound {least:.4f} ms by {by}; host {row['kernel_host_us']:.1f} vs "
              f"{row['cudnn_host_us']:.1f} us a call", flush=True)
    total = {key: sum(r[key] * r["launches"] for r in rows)
             for key in ("kernel_ms", "wide_ms", "narrow_ms", "tile_ms", "cudnn_ms", "bound_ms")}
    print(f"{model} bucket {bucket}: {sum(r['launches'] for r in rows)} launches a step, kernel "
          f"{total['kernel_ms']:.4f} ms, wide strip alone {total['wide_ms']:.4f}, narrow strip "
          f"alone {total['narrow_ms']:.4f}, tile alone {total['tile_ms']:.4f}, cuDNN "
          f"{total['cudnn_ms']:.4f}, bound {total['bound_ms']:.4f} ms")
    result = {"card": card, "model": model, "bucket": bucket, "step": total, "shapes": rows}
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", nargs="+",
                    default=["efficientnet_b4", "mobilenetv3_small", "convnext_tiny"])
    ap.add_argument("--bucket", type=int, nargs="+", default=[32])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    ahead = torch.ones((8192, 8192), device="cuda", dtype=torch.bfloat16)
    for bucket in args.bucket:
        for model in args.model:
            bench_model(model, bucket, args.iters, card, ahead)


if __name__ == "__main__":
    main()
