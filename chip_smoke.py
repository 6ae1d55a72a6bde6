#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.

1. The card's name and power limit, as ``nvidia-smi`` gives them.
2. Build every CUDA kernel from ``ics_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all started together) and time it.
3. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with the tolerance stated beside each case.
4. CUDA-event times of each kernel and its plain version, in turns.
5. ViT-B/16 @384 at full width (random weights from seed 0) in this
   process: the bf16 forward through the kernel against the fp32 forward
   through the plain version.
6. The main path: ``python -m ics_tpu_torch.main`` serving ViT-B/16 @384,
   classify requests over HTTP; the kernel launch counts are set to 0 just
   before and read just after, and every kernel of the path must have run.

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
MODEL = "vit_b16"
DEPTH = 12        # ViT-B/16: one flash launch per block per batch
SERVER_START_S = 600


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


def time_attention(torch, attention) -> tuple[float, float]:
    """Phase 4: ms per call at the serving bucket's shape, kernel and plain
    version in turns (kernel, plain, plain, kernel)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((32, 12, 577, 64), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kernel = lambda: attention.flash_attention(q, k, v)  # noqa: E731
    plain = lambda: attention.attention_reference(q, k, v)  # noqa: E731
    for fn in (kernel, plain):
        cuda_ms(fn, 3)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name].append(cuda_ms(kernel if name == "kernel" else plain, 20))
    ms, plain_ms = (sum(v) / len(v) for v in (runs["kernel"], runs["plain"]))
    log(f"  flash_attention [32, 12, 577, 64] bf16: kernel {runs['kernel']} ms, "
        f"plain {runs['plain']} ms; mean {ms:.4f} vs {plain_ms:.4f} ms")
    return ms, plain_ms


def check_model(torch) -> None:
    """Phase 5: full-width ViT-B/16, bf16 through the kernel, against fp32
    through the plain version. The kernel path's largest logit deviation
    must stay within twice the plain bf16 path's own."""
    from ics_tpu_torch.models.registry import get_model

    spec = get_model(MODEL)
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
    log(f"  {MODEL} logits [4, 1000]: fp32 kernel vs fp32 plain max|d|={fp32_gap:.3e} "
        f"(tol 1e-3); bf16 kernel {kernel_gap:.3e} vs bf16 plain {plain_gap:.3e} "
        f"from fp32 (tol 2x); top-1 agreement {top1:.2f}")
    if not bool(torch.isfinite(kernel_bf16).all()):
        fail("non-finite logits from the kernel path")
    if fp32_gap > 1e-3 or kernel_gap > 2 * plain_gap:
        fail("full-width forward through the kernel disagrees with the plain version")
    del f32, bf16
    torch.cuda.empty_cache()


def _jpegs() -> list[bytes]:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for h, w in [(480, 640), (512, 384), (400, 400), (300, 500), (640, 427),
                 (384, 384), (256, 512), (500, 375), (420, 600)]:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        img = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_result(res: dict) -> None:
    import math

    idx, scores = res["top_classes"], res["scores"]
    if res["model"] != MODEL or len(idx) != 5 or len(scores) != 5:
        fail(f"malformed classify result: {res}")
    if len(set(idx)) != 5 or not all(0 <= i < 1000 for i in idx):
        fail(f"bad class indices: {idx}")
    if not all(math.isfinite(s) and 0.0 < s <= 1.0 for s in scores) or \
            any(a < b for a, b in zip(scores, scores[1:])):
        fail(f"bad scores: {scores}")


async def drive_server(base: str, admin: tuple[str, str]) -> dict:
    """Phase 6 over HTTP; returns the counts and stats of the drive."""
    import httpx

    jpegs = _jpegs()
    async with httpx.AsyncClient(base_url=base, timeout=300) as c:
        r = await c.post("/auth/login", data={"username": admin[0], "password": admin[1]})
        r.raise_for_status()
        c.cookies.clear()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}

        async def classify(blobs):
            files = [("files", (f"img{i}.jpg", b, "image/jpeg")) for i, b in enumerate(blobs)]
            r = await c.post("/inferencia/classificar", files=files, headers=h)
            if r.status_code != 200:
                fail(f"/inferencia/classificar returned {r.status_code}: {r.text[:500]}")
            return r.json()["resultados"]

        before = (await c.get("/inferencia/status", headers=h)).json()
        (await c.post("/inferencia/kernels/zerar", headers=h)).raise_for_status()
        # the main path: 6 images in one request (the batcher forms a batch
        # of them) beside 3 single-image requests, then one image twice alone
        t0 = time.perf_counter()
        results = await asyncio.gather(
            classify(jpegs[:6]), *(classify([b]) for b in jpegs[6:9])
        )
        again = [await classify([jpegs[8]]) for _ in range(2)]
        wall_s = time.perf_counter() - t0
        after = (await c.get("/inferencia/status", headers=h)).json()
    served = [res for batch in results for res in batch] + [a[0] for a in again]
    for res in served:
        _check_result(res)
    if again[0][0]["top_classes"] != again[1][0]["top_classes"] or \
            again[0][0]["scores"] != again[1][0]["scores"]:
        fail("the same image alone twice gave two different results")
    return {
        "images": len(served),
        "batches": after["batches"] - before["batches"],
        "launches": after["kernel_launches"],
        "backend": after["backend"],
        "device_name": after["device_name"],
        "max_batch_seen": after["batcher"]["max_batch_seen"],
        "wall_s": wall_s,
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
            TPU_DEFAULT_MODEL=MODEL,
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "ics_tpu_torch").is_dir():
        fail(f"ics_tpu_torch not found beside {Path(__file__).name}; run from a checkout")
    sys.path.insert(0, str(ROOT))
    from ics_tpu_torch import disable_tf32
    from ics_tpu_torch.ops import _build, attention

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
    max_err = check_attention(torch, attention)

    log("[4] CUDA-event times:")
    ms, plain_ms = time_attention(torch, attention)

    log(f"[5] {MODEL} @384 full width in-process, kernel path against plain path:")
    check_model(torch)

    log(f"[6] main path: python -m ics_tpu_torch.main serving {MODEL}, classify over HTTP:")
    drive = serve_and_drive()
    log(f"  {json.dumps(drive)}")
    launches = drive["launches"]["flash_attention"]
    if drive["backend"] != "cuda":
        fail(f"/inferencia/status reports backend {drive['backend']!r}, not 'cuda'")
    if drive["batches"] < 1 or launches < DEPTH * drive["batches"]:
        fail(f"flash_attention launched {launches} times for {drive['batches']} "
             f"batches; the main path must launch it {DEPTH} times per batch")
    if drive["max_batch_seen"] < 2:
        fail("the batcher never formed a batch larger than 1")

    log(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "ics_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "ics_tpu/ops/attention.py:170",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
