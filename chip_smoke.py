#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.

1. The card's name and power limit, as ``nvidia-smi`` gives them.
2. Build every CUDA kernel from ``ics_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all started together) and time it.
3. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes, with the tolerance stated beside each
   case: ``flash_attention``, ``bottleneck_chain``, ``normalize_u8``.
4. CUDA-event times of each kernel and its plain version, in turns, at the
   bucket-32 shapes, with the least time the card could take computed from
   the shapes; ``F.scaled_dot_product_attention`` as a yardstick for the
   attention kernel (timed here, used nowhere in the port).
5. ViT-B/16 @384 at full width (random weights from seed 0) in this
   process: the bf16 forward through the kernel against the fp32 forward
   through the plain version.
5b. ResNet-50 at full width in this process: bf16 with fused chains against
   the fp32 unfused forward, beside the bf16 unfused (cuDNN) forward; then
   one bucket-32 engine step with the chains on and off.
6. The main paths: one ``python -m ics_tpu_torch.main`` whose default model
   is ResNet-50 with ``TPU_FUSED_CHAINS=true``, classify requests over HTTP:
   JPEGs to ResNet-50, the same JPEGs to ``?modelo=vit_b16`` (the pool
   builds it), then a batch of 384x384 PNGs to ViT-B/16 (the fixed-size
   lane). The kernel launch counts are set to 0 just before each stretch
   and read just after, and every kernel of that stretch's path must have
   run.

Prints ``{"kernels": [...]}`` on the line before the last and
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when no CUDA device is visible, when the package is not beside the
script, or when any phase fails.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BF16_TOL = 1e-2   # outputs are O(1); one bf16 ulp at 1.0 is 7.8e-3
FP32_TOL = 1e-5   # the same fp32 math summed in another order
# bottleneck_chain: a, cmid and the output are each rounded once from an fp32
# sum that the kernel and the plain version take in another order. Where such
# a sum lands on the other side of a rounding tie the two differ by one bf16
# ulp of that value; at the output that is at most 2^-6 for |y| < 4 (the
# cases keep |y| < 4), and a flipped a or cmid carried forward may move a
# second output rounding: two ulps, 2^-5. The flips are few, so the mean
# error stays far below an ulp.
CHAIN_TOL = 2.0 ** -5
CHAIN_MEAN_TOL = 1e-3
NORM_BF16_TOL = 2.0 ** -6   # one bf16 ulp of the largest output, |y| < 4
VIT = "vit_b16"
RESNET = "resnet50"
VIT_DEPTH = 12              # ViT-B/16: one flash launch per block per batch
CHAIN_LAUNCHES = 5          # ResNet-50: one launch per chained bottleneck, 2 + 3
SERVER_START_S = 600
# published peaks of one H100 SXM: device memory, dense bf16 tensor cores, fp32
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_attention(torch, attention) -> float:
    """Phase 3: kernel against plain version; returns the largest error."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ((8, 12, 577, 64), torch.bfloat16, None),
        ((8, 12, 577, 64), torch.float32, None),
        ((8, 12, 577, 64), torch.bfloat16, 300),
        ((8, 12, 577, 64), torch.float32, 300),
        ((8, 12, 577, 64), torch.bfloat16, 0),
        ((1, 12, 1100, 64), torch.bfloat16, None),
        ((1, 12, 1100, 64), torch.float32, 0),
        ((2, 3, 130, 16), torch.bfloat16, None),
        ((2, 3, 130, 32), torch.bfloat16, None),
        ((2, 3, 130, 128), torch.bfloat16, None),
        ((2, 3, 130, 128), torch.float32, None),
    ]
    worst = 0.0
    for shape, dtype, seq_len in cases:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
        out = attention.flash_attention(q, k, v, seq_len)
        ref = attention.attention_reference(q, k, v, seq_len)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        exact_zero = bool((out == 0).all()) if seq_len == 0 else None
        log(f"  flash_attention {list(shape)} {str(dtype)[6:]} seq_len={seq_len}: "
            f"max_abs_err={err:.3e} (tol {tol:g})"
            + ("" if exact_zero is None else f" exact_zeros={exact_zero}"))
        if not finite or err > tol or exact_zero is False:
            fail(f"flash_attention disagrees with its plain version at {shape} "
                 f"{dtype} seq_len={seq_len}: err {err}, finite {finite}")
        worst = max(worst, err)
    return worst


def in_turns(label: str, kernel, plain, iters: int = 20) -> tuple[float, float]:
    """ms per call of a kernel and its plain version, in turns (kernel,
    plain, plain, kernel) after a warm-up of each."""
    for fn in (kernel, plain):
        cuda_ms(fn, 3)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name].append(cuda_ms(kernel if name == "kernel" else plain, iters))
    ms, plain_ms = (sum(v) / len(v) for v in (runs["kernel"], runs["plain"]))
    log(f"  {label}: kernel {runs['kernel']} ms, plain {runs['plain']} ms; "
        f"mean {ms:.4f} vs {plain_ms:.4f} ms")
    return ms, plain_ms


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def time_attention(torch, attention) -> dict:
    """Phase 4: the flash kernel at the serving bucket's shape."""
    import torch.nn.functional as F

    shape = (32, 12, 577, 64)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ms, plain_ms = in_turns(
        f"flash_attention {list(shape)} bf16",
        lambda: attention.flash_attention(q, k, v),
        lambda: attention.attention_reference(q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    cuda_ms(sdpa, 3)
    library_ms = (cuda_ms(sdpa, 20) + cuda_ms(sdpa, 20)) / 2
    b, h, s, d = shape
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           **bound(4 * q.numel() * 2, 4.0 * b * h * s * s * d, BF16_FLOPS)}
    log(f"    F.scaled_dot_product_attention (yardstick only) {library_ms:.4f} ms; "
        f"bound {out['bound_ms']:.4f} ms by {out['bound_by']}")
    return out


def make_chain(torch, n: int, c: int, cm: int, seed: int) -> dict:
    """Random packed chain weights on the card: He-scaled convolutions, a
    small residual branch and BatchNorm near identity, so that the chain's
    output stays O(1) (below 4 for unit-normal input halved)."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    packed = {
        "w1": (randn(n, c, cm) * (2.0 / c) ** 0.5).bfloat16(),
        "w2": (randn(n, 9 * cm, cm) * (2.0 / (9 * cm)) ** 0.5).bfloat16(),
        "w3": (randn(n, cm, c) * 0.25 * (1.0 / cm) ** 0.5).bfloat16(),
    }
    for i, width in ((1, cm), (2, cm), (3, c)):
        packed[f"s{i}"] = 1.0 + 0.1 * randn(n, 1, width)
        packed[f"b{i}"] = 0.1 * randn(n, 1, width)
    return {k: v.cuda() for k, v in packed.items()}


def chain_input(torch, shape, seed: int):
    g = torch.Generator().manual_seed(seed)
    return (0.5 * torch.randn(shape, generator=g)).bfloat16().cuda()


def check_chain(torch, bottleneck) -> float:
    """Phase 3: bottleneck_chain against its plain version; the largest error."""
    cases = [
        ((8, 56, 56, 256), 64, 2),     # ResNet-50 stage 0
        ((8, 28, 28, 512), 128, 3),    # ResNet-50 stage 1
        ((2, 7, 7, 256), 64, 2),       # a whole image in one tile, W not a multiple of 8
        ((1, 14, 14, 1024), 256, 1),   # the widest inner width, a short last tile
    ]
    worst = 0.0
    for shape, cm, n in cases:
        packed = make_chain(torch, n, shape[-1], cm, seed=0)
        x = chain_input(torch, shape, seed=1)
        out = bottleneck.bottleneck_chain(x, packed)
        torch.cuda.synchronize()
        ref = bottleneck.bottleneck_chain_reference(x, packed)
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        top = ref.float().abs().max().item()
        log(f"  bottleneck_chain {list(shape)} Cm={cm} N={n} bf16: max_abs_err={err:.3e} "
            f"(tol {CHAIN_TOL:g}), mean {mean:.2e} (tol {CHAIN_MEAN_TOL:g}), max|y|={top:.2f}")
        if not bool(torch.isfinite(out).all()) or top >= 4 or err > CHAIN_TOL \
                or mean > CHAIN_MEAN_TOL:
            fail(f"bottleneck_chain disagrees with its plain version at {shape} "
                 f"Cm={cm} N={n}: err {err}, mean {mean}, max|y| {top}")
        worst = max(worst, err)
    return worst


def check_normalize(torch, normalize) -> float:
    """Phase 3: normalize_u8 against its plain version; the largest error."""
    from ics_tpu_torch.ops.preproc import normalize_only

    worst = 0.0
    g = torch.Generator().manual_seed(2)
    for (b, h, w), canvas in [((32, 384, 384), 512), ((2, 224, 224), None), ((1, 7, 13), None)]:
        full = torch.randint(0, 256, (b, canvas or h, canvas or w, 3), generator=g,
                             dtype=torch.uint8).cuda()
        x = full[:, :h, :w]        # a strided window when there is a canvas
        for dtype, tol in ((torch.bfloat16, NORM_BF16_TOL), (torch.float32, FP32_TOL)):
            out = normalize.normalize_u8(x, dtype=dtype)
            torch.cuda.synchronize()
            err = (out.float() - normalize_only(x, dtype=dtype).float()).abs().max().item()
            log(f"  normalize_u8 {[b, h, w, 3]}" + (f" of a {canvas} canvas" if canvas else "")
                + f" -> {str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol:g})")
            if not bool(torch.isfinite(out).all()) or err > tol:
                fail(f"normalize_u8 disagrees with its plain version at {(b, h, w)} {dtype}")
            worst = max(worst, err)
    return worst


def time_chain(torch, bottleneck) -> dict:
    """Phase 4: both ResNet-50 chains of one bucket-32 step (5 launches)."""
    total = {"ms": 0.0, "plain_ms": 0.0}
    n_bytes = n_ops = 0.0
    for shape, cm, n in [((32, 56, 56, 256), 64, 2), ((32, 28, 28, 512), 128, 3)]:
        packed = make_chain(torch, n, shape[-1], cm, seed=0)
        x = chain_input(torch, shape, seed=1)
        ms, plain_ms = in_turns(
            f"bottleneck_chain {list(shape)} Cm={cm} N={n} bf16",
            lambda: bottleneck.bottleneck_chain(x, packed),
            lambda: bottleneck.bottleneck_chain_reference(x, packed), iters=10)
        c = shape[-1]
        # x read once, the output written once, the weights read once; per
        # pixel and bottleneck 2 * (C*Cm + 9*Cm*Cm + Cm*C) operations
        case_bytes = 2 * x.numel() * 2 + sum(
            v.numel() * v.element_size() for v in packed.values())
        case_ops = 2.0 * n * (x.numel() // c) * (2 * c * cm + 9 * cm * cm)
        b = bound(case_bytes, case_ops, BF16_FLOPS)
        log(f"    {case_bytes / 1e6:.1f} MB, {case_ops / 1e9:.1f} GFLOP: bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}; {case_ops / ms / 1e9:.1f} TFLOP/s")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        n_bytes += case_bytes
        n_ops += case_ops
    return {**total, "library_ms": None, **bound(n_bytes, n_ops, BF16_FLOPS)}


def time_normalize(torch, normalize) -> dict:
    """Phase 4: the 384 window of a bucket-32 canvas of 512, to bf16."""
    from ics_tpu_torch.ops.preproc import normalize_only

    g = torch.Generator().manual_seed(3)
    canvas = torch.randint(0, 256, (32, 512, 512, 3), generator=g, dtype=torch.uint8).cuda()
    x = canvas[:, :384, :384]
    ms, plain_ms = in_turns(
        "normalize_u8 [32, 384, 384, 3] of a 512 canvas -> bf16",
        lambda: normalize.normalize_u8(x), lambda: normalize_only(x))
    # 1 byte in and 2 out per value; a multiply and an add on each, in fp32
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           **bound(x.numel() * 3, 2.0 * x.numel(), FP32_FLOPS)}
    log(f"    bound {out['bound_ms']:.4f} ms by {out['bound_by']}")
    return out


def check_model(torch) -> None:
    """Phase 5: full-width ViT-B/16, bf16 through the kernel, against fp32
    through the plain version. The kernel path's largest logit deviation
    must stay within twice the plain bf16 path's own."""
    from ics_tpu_torch.models.registry import get_model

    spec = get_model(VIT)
    model = spec.build(num_classes=1000).init_weights(torch.Generator().manual_seed(0))
    f32 = model.to("cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4, spec.image_size, spec.image_size, 3), generator=g, device="cuda")
    with torch.inference_mode():
        ref = f32(x, use_flash=False)
        f32_kernel = f32(x, use_flash=True)
        bf16 = f32.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        plain_bf16 = bf16(xb, use_flash=False).float()
        kernel_bf16 = bf16(xb, use_flash=True).float()
    torch.cuda.synchronize()
    fp32_gap = (f32_kernel - ref).abs().max().item()
    plain_gap = (plain_bf16 - ref).abs().max().item()
    kernel_gap = (kernel_bf16 - ref).abs().max().item()
    top1 = (kernel_bf16.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"  {VIT} logits [4, 1000]: fp32 kernel vs fp32 plain max|d|={fp32_gap:.3e} "
        f"(tol 1e-3); bf16 kernel {kernel_gap:.3e} vs bf16 plain {plain_gap:.3e} "
        f"from fp32 (tol 2x); top-1 agreement {top1:.2f}")
    if not bool(torch.isfinite(kernel_bf16).all()):
        fail("non-finite logits from the kernel path")
    if fp32_gap > 1e-3 or kernel_gap > 2 * plain_gap:
        fail("full-width forward through the kernel disagrees with the plain version")
    del f32, bf16
    torch.cuda.empty_cache()


def check_resnet(torch) -> None:
    """Phase 5b: full-width ResNet-50. bf16 with the fused chains against
    the fp32 unfused forward: its largest logit deviation must stay within
    twice that of the bf16 unfused (cuDNN) forward. Then one bucket-32
    engine step with the chains on and off, by CUDA events."""
    import numpy as np

    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.runtime.engine import InferenceEngine

    spec = get_model(RESNET)

    def build(fused: bool, dtype):
        model = spec.build(num_classes=1000).init_weights(torch.Generator().manual_seed(0))
        return model.fold(fused_chains=fused).to(device="cuda", dtype=dtype).eval()

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((8, spec.image_size, spec.image_size, 3), generator=g, device="cuda")
    with torch.inference_mode():
        ref = build(False, torch.float32).apply_folded(x)
        xb = x.to(torch.bfloat16)
        unfused = build(False, torch.bfloat16).apply_folded(xb).float()
        fused = build(True, torch.bfloat16).apply_folded(xb).float()
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    unfused_gap = (unfused - ref).abs().max().item()
    fused_gap = (fused - ref).abs().max().item()
    top1 = (fused.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"  {RESNET} logits [8, 1000] (max|logit| {scale:.3e}): bf16 fused chains "
        f"{fused_gap:.3e} vs bf16 unfused {unfused_gap:.3e} from fp32 unfused (tol 2x); "
        f"top-1 agreement {top1:.2f}")
    if not bool(torch.isfinite(fused).all()) or fused_gap > 2 * unfused_gap:
        fail("full-width ResNet-50 through the fused chains disagrees with the unfused forward")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (32, 512, 512, 3), np.uint8)
    sizes = rng.integers(300, 513, (32, 2)).astype(np.int32)
    engines = {
        name: InferenceEngine(RESNET, precision="bf16", buckets=(32,), canvas=512,
                              fused_chains=name == "fused")
        for name in ("fused", "unfused")
    }
    staged = engines["fused"]._to_device(canvas, sizes)
    steps = {name: (lambda e=e: e._step(*staged)) for name, e in engines.items()}
    ms, plain_ms = in_turns(f"{RESNET} bf16 engine step at bucket 32, chains on (kernel) "
                            "and off (cuDNN, under 'plain')",
                            steps["fused"], steps["unfused"], iters=10)
    log(f"    {32 / ms * 1e3:.0f} images/s with the chains, {32 / plain_ms * 1e3:.0f} without")
    del engines, steps, staged
    torch.cuda.empty_cache()


JPEG_SIZES = [(480, 640), (512, 384), (400, 400), (300, 500), (640, 427),
              (384, 360), (256, 512), (500, 375), (420, 600)]


def _images(sizes, fmt: str, **save_kwargs) -> list[bytes]:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for h, w in sizes:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        img = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt, **save_kwargs)
        out.append(buf.getvalue())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_result(res: dict, model: str) -> None:
    import math

    idx, scores = res["top_classes"], res["scores"]
    if res["model"] != model or len(idx) != 5 or len(scores) != 5:
        fail(f"malformed classify result (wanted model {model}): {res}")
    if len(set(idx)) != 5 or not all(0 <= i < 1000 for i in idx):
        fail(f"bad class indices: {idx}")
    # random weights can make a softmax so peaked that the tail scores
    # underflow to 0: finite, in [0, 1], in order, the best above 0
    if not all(math.isfinite(s) and 0.0 <= s <= 1.0 for s in scores) or scores[0] <= 0.0 \
            or any(a < b for a, b in zip(scores, scores[1:])):
        fail(f"bad scores: {scores}")


async def drive_server(base: str, admin: tuple[str, str]) -> dict:
    """Phase 6 over HTTP: three stretches, the launch counts zeroed before
    and read after each. Returns each stretch's counts and stats."""
    import httpx

    jpegs = _images(JPEG_SIZES, "JPEG", quality=90)
    pngs = _images([(384, 384)] * 4, "PNG")
    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        r = await c.post("/auth/login", data={"username": admin[0], "password": admin[1]})
        r.raise_for_status()
        c.cookies.clear()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}

        async def classify(blobs, model, query, kind="jpg"):
            files = [("files", (f"img{i}.{kind}", b, f"image/{kind}"))
                     for i, b in enumerate(blobs)]
            r = await c.post(f"/inferencia/classificar{query}", files=files, headers=h)
            if r.status_code != 200:
                fail(f"/inferencia/classificar{query} returned {r.status_code}: {r.text[:500]}")
            results = r.json()["resultados"]
            for res in results:
                _check_result(res, model)
            return results

        async def status(model):
            r = await c.get(f"/inferencia/status?modelo={model}", headers=h)
            return r.json() if r.status_code == 200 else {"batches": 0, "images": 0}

        async def stretch(name, model, query, requests):
            """Zero the counts, send ``requests`` (lists of blobs) together,
            then one image twice alone; read the counts."""
            before = await status(model)
            (await c.post("/inferencia/kernels/zerar", headers=h)).raise_for_status()
            t0 = time.perf_counter()
            kind = "png" if name == "vit_png" else "jpg"
            results = await asyncio.gather(
                *(classify(blobs, model, query, kind) for blobs in requests))
            again = [await classify(requests[-1][-1:], model, query, kind) for _ in range(2)]
            wall_s = time.perf_counter() - t0
            if again[0][0]["top_classes"] != again[1][0]["top_classes"] or \
                    again[0][0]["scores"] != again[1][0]["scores"]:
                fail(f"{name}: the same image alone twice gave two different results")
            after = await status(model)
            return {
                "model": model,
                "images": sum(len(r) for r in results) + 2,
                "batches": after["batches"] - before["batches"],
                "launches": after["kernel_launches"],
                "backend": after["backend"],
                "fused_chains": after["fused_chains"],
                "max_batch_seen": after["batcher"]["max_batch_seen"],
                "wall_s": wall_s,
            }

        # 6 images in one request (the batcher forms a batch of them) beside
        # 3 single-image requests; then the same to ViT-B/16, which the pool
        # builds on its first request; then 4 PNGs that are exactly 384x384
        mixed = [jpegs[:6], *([b] for b in jpegs[6:9])]
        return {
            "resnet_jpeg": await stretch("resnet_jpeg", RESNET, "", mixed),
            "vit_jpeg": await stretch("vit_jpeg", VIT, f"?modelo={VIT}", mixed),
            "vit_png": await stretch("vit_png", VIT, f"?modelo={VIT}", [pngs]),
        }


def serve_and_drive() -> dict:
    port = _free_port()
    admin = ("smoke-admin@example.com", "smoke-" + os.urandom(8).hex())
    with tempfile.TemporaryDirectory(prefix="ics_tpu_torch_smoke_") as tmp:
        env = dict(
            os.environ,
            ENV="test",
            DATABASE_URL=f"sqlite:///{tmp}/smoke.db",
            JWT_SECRET_KEY=os.urandom(16).hex(),
            ADMIN_EMAIL=admin[0],
            ADMIN_SENHA=admin[1],
            NEXTCLOUD_BASE_URL="",
            TPU_ENABLE_INFERENCE="true",
            TPU_DEFAULT_MODEL=RESNET,
            TPU_FUSED_CHAINS="true",
            TPU_PRECISION="bf16",
            TPU_DEVICE_DECODE="false",
            TPU_BATCH_BUCKETS="1,8,32",
            TPU_WARMUP_ON_STARTUP="true",
        )
        server_log = Path(tmp) / "server.log"
        with open(server_log, "w") as log_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ics_tpu_torch.main", "--host", "127.0.0.1",
                 "--port", str(port)],
                cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT,
            )
            try:
                import httpx

                base = f"http://127.0.0.1:{port}"
                t0 = time.perf_counter()
                while True:
                    if proc.poll() is not None:
                        fail(f"server exited with {proc.returncode}:\n"
                             f"{server_log.read_text()[-4000:]}")
                    try:
                        if httpx.get(f"{base}/health", timeout=2).status_code == 200:
                            break
                    except httpx.TransportError:
                        pass
                    if time.perf_counter() - t0 > SERVER_START_S:
                        fail(f"server not up after {SERVER_START_S} s:\n"
                             f"{server_log.read_text()[-4000:]}")
                    time.sleep(1)
                log(f"  server up in {time.perf_counter() - t0:.1f} s (engine built, buckets warmed)")
                return asyncio.run(drive_server(base, admin))
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def check_drive(drive: dict) -> dict:
    """Phase 6's verdict: every stretch ran on the card, through the kernels
    of its path and no other. Returns the launches per kernel."""
    for name, st in drive.items():
        log(f"  {name}: {json.dumps(st)}")
        if st["backend"] != "cuda":
            fail(f"{name}: /inferencia/status reports backend {st['backend']!r}, not 'cuda'")
        if st["batches"] < 1:
            fail(f"{name}: no batch ran")
    res, jpg, png = drive["resnet_jpeg"], drive["vit_jpeg"], drive["vit_png"]
    if not res["fused_chains"]:
        fail("the ResNet-50 engine reports fused_chains off")
    if res["launches"]["bottleneck_chain"] < CHAIN_LAUNCHES * res["batches"] \
            or res["launches"]["flash_attention"] != 0:
        fail(f"resnet_jpeg: {res['launches']} for {res['batches']} batches; the path "
             f"must launch bottleneck_chain {CHAIN_LAUNCHES} times per batch and "
             "flash_attention never")
    for name, st in (("vit_jpeg", jpg), ("vit_png", png)):
        if st["launches"]["flash_attention"] < VIT_DEPTH * st["batches"] \
                or st["launches"]["bottleneck_chain"] != 0:
            fail(f"{name}: {st['launches']} for {st['batches']} batches; the path must "
                 f"launch flash_attention {VIT_DEPTH} times per batch and "
                 "bottleneck_chain never")
    if jpg["launches"]["normalize_u8"] != 0 or res["launches"]["normalize_u8"] != 0:
        fail("normalize_u8 ran on a JPEG stretch: none of those batches is all 384x384")
    if png["launches"]["normalize_u8"] < 1:
        fail("vit_png: a batch of exact 384x384 images did not take the fixed-size lane")
    if max(res["max_batch_seen"], jpg["max_batch_seen"]) < 2:
        fail("the batcher never formed a batch larger than 1")
    return {
        "flash_attention": jpg["launches"]["flash_attention"] + png["launches"]["flash_attention"],
        "bottleneck_chain": res["launches"]["bottleneck_chain"],
        "normalize_u8": png["launches"]["normalize_u8"],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "ics_tpu_torch").is_dir():
        fail(f"ics_tpu_torch not found beside {Path(__file__).name}; run from a checkout")
    sys.path.insert(0, str(ROOT))
    from ics_tpu_torch import disable_tf32
    from ics_tpu_torch.ops import _build, attention, bottleneck, normalize

    disable_tf32()
    log("[1] card (nvidia-smi name, power.limit):")
    card = card_line()
    log(card)

    log("[2] kernel build (nvcc, sm_90a, one process per source):")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3] kernels against their plain versions on the card:")
    errs = {
        "flash_attention": check_attention(torch, attention),
        "bottleneck_chain": check_chain(torch, bottleneck),
        "normalize_u8": check_normalize(torch, normalize),
    }

    log("[4] CUDA-event times at the bucket-32 shapes, and the card's bound:")
    times = {
        "flash_attention": time_attention(torch, attention),
        "bottleneck_chain": time_chain(torch, bottleneck),
        "normalize_u8": time_normalize(torch, normalize),
    }
    torch.cuda.empty_cache()

    log(f"[5] {VIT} @384 full width in-process, kernel path against plain path:")
    check_model(torch)

    log(f"[5b] {RESNET} full width in-process, fused chains against unfused:")
    check_resnet(torch)

    log(f"[6] main paths: python -m ics_tpu_torch.main serving {RESNET} (fused chains) "
        f"and {VIT}, classify over HTTP:")
    launches = check_drive(serve_and_drive())

    sources = {
        "flash_attention": ("ics_tpu_torch/ops/csrc/flash_attention.cu",
                            "ics_tpu/ops/attention.py:170"),
        "bottleneck_chain": ("ics_tpu_torch/ops/csrc/bottleneck_chain.cu",
                             "ics_tpu/ops/pallas_bottleneck.py:164"),
        "normalize_u8": ("ics_tpu_torch/ops/csrc/normalize_u8.cu",
                         "ics_tpu/ops/pallas_preproc.py:67"),
    }
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        **times[name],
    } for name, (source, replaces) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
