"""The device decode of the JPEG-coefficient lanes on the GPU, by sampling mode and bucket.

    python -m ics_tpu_torch.tools.bench_decode [--bucket 32 8 1] [--mode 420 422 444 gray]

For each mode and bucket: ``runtime.device_decode.decode_batch_to_canvas`` as
the coefficient step runs it, on a staged batch of seeded JPEGs (blurred
noise, 500x375, quality 90, on the 512 px lane), by CUDA events after a
warm-up; the CUDA kernels one call launches (``torch.profiler``); the host's
time to queue a call; and the least time the card could take
(``decode_bound``). ``measure_decode`` is the one timer and bound of the
decode: ``chip_smoke.py`` calls it too. To compare two versions, run the
tool from each checkout in one call. The card's name and power limit come
first; one JSON line carries the numbers.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess

import numpy as np
import torch

from ics_tpu_torch import disable_tf32
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.runtime import device_decode
from ics_tpu_torch.tools.profile_step import events_ms, host_ms

HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
# a block's iDCT as two 8x8x8 products (f = B^T F B) and its dequant
OPS_A_BLOCK = 2 * 2 * 8 ** 3 + 64


def jpegs(mode: str, n: int) -> list[bytes]:
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(0)
    out = []
    for _ in range(min(n, 4)):
        img = Image.fromarray(rng.integers(0, 256, (375, 500, 3), np.uint8)).filter(
            ImageFilter.GaussianBlur(2))
        buf = io.BytesIO()
        if mode == "gray":
            img.convert("L").save(buf, "JPEG", quality=90)
        else:
            img.save(buf, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[mode])
        out.append(buf.getvalue())
    return [out[i % len(out)] for i in range(n)]


def count_kernels(fn):
    """CUDA kernels one call of ``fn`` launches (copies and fills not
    counted), by ``torch.profiler``; None when it sees none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(("Memcpy", "Memset"))) or None


def decode_bound(dev: dict, canvas: torch.Tensor, mode: str) -> dict:
    """The least time the card could take for ``decode_batch_to_canvas(dev,
    mode=mode)``, which gave ``canvas``: the tensors this mode reads (gray no
    chroma, 4:4:4 no ``sizes``) read once and the canvas's storage (gray's
    is one plane behind a view of three) written once at the memory rate;
    the iDCT's separable products and the dequant of the blocks it decodes
    at the fp32 rate (TF32 is off); whichever is longer."""
    keys = ["y", "yq"]
    if mode != "gray":
        keys += ["cb", "cq", "cr", "rq"]
    if mode not in ("gray", "444"):
        keys.append("sizes")
    n_bytes = sum(dev[k].numel() * dev[k].element_size() for k in keys)
    n_bytes += canvas.untyped_storage().nbytes()
    blocks = sum(dev[k].numel() for k in ("y", "cb", "cr") if k in keys) // 64
    n_ops = blocks * OPS_A_BLOCK
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / FP32_FLOPS * 1e3
    return {"bytes": n_bytes, "operations": n_ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def measure_decode(dev: dict, mode: str, iters: int = 20) -> dict:
    """``decode_batch_to_canvas`` on the staged tensors ``dev`` (on the card):
    ms a call by CUDA events (the mean of two runs after a warm-up), the
    kernels a call launches, the host's ms to queue a call, and its bound."""
    def call():
        with torch.inference_mode():
            return device_decode.decode_batch_to_canvas(dev, mode=mode)

    canvas = call()
    events_ms(call, 3)
    runs = [events_ms(call, iters) for _ in range(2)]
    return {"ms": sum(runs) / len(runs), "runs_ms": runs, "kernels": count_kernels(call),
            "host_ms": host_ms(call, iters), **decode_bound(dev, canvas, mode)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bucket", type=int, nargs="+", default=[32, 8, 1])
    parser.add_argument("--mode", nargs="+", default=["420", "422", "444", "gray"])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for mode in args.mode:
        for bucket in args.bucket:
            staged = device_decode.stage_coefficient_batch(
                [imgcodec.jpeg_coefficients(b) for b in jpegs(mode, bucket)],
                device_decode.LUMA_BLOCKS, mode)
            dev = device_decode.to_device(staged, "cuda")
            row = {"mode": mode, "bucket": bucket, **measure_decode(dev, mode, args.iters)}
            rows.append(row)
            print(f"{mode} bucket {bucket}: {row['ms']:.4f} ms ({row['kernels']} kernels, host "
                  f"{row['host_ms']:.3f} ms); bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({row['bytes']} bytes, {row['operations']} operations)",
                  flush=True)
            del dev
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
