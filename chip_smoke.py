#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.

1. The card's name and power limit, as ``nvidia-smi`` gives them.
2. Build every CUDA kernel from ``ics_tpu_torch/ops/csrc`` (six sources
   and two shared headers, one ``nvcc`` per source, all started together)
   and time it.
3. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes, with the tolerance stated beside each
   case: ``flash_attention`` (and its ``bf16_exp`` variant; sequence lengths
   on both sides of its tile edges, every head_dim, masked keys, strided
   views of a fused qkv product and ``flash_attention_qkv``, NaN behind
   ``seq_len`` and behind the last image, each case twice),
   ``bottleneck_chain`` (both ResNet-50 chains at every bucket of phase 6's
   server, since the tiling depends on the batch; pixels that are no
   multiple of an M tile, a short last tile, Cm 64, 128 and 256, the
   large-bias border case, each case twice), ``normalize_u8``,
   ``depthwise_conv`` (every call of ConvNeXt-T, MobileNetV3-Small and
   EfficientNet-B4 at every bucket; both sides of the strip kernel's block edges, images
   smaller than k, C of 8 to 88 and an odd C, k 3 to 9, both weight layouts,
   NaN around x, each case twice), ``window_attention`` through both of its
   entries (the 4-D one at Swin-T's stages and swin_micro's; the qkv one at
   every Swin-T call at each bucket of phase 6's server, the windows of
   shifted blocks wrapping round the image's edge, ww 16, 25, 9 and 64, NaN
   in the image behind the batch, with the heads a work item takes in the
   log; each case twice).
4. CUDA-event times of each kernel and its plain version, in turns, at the
   bucket-32 shapes, with the least time the card could take computed from
   the shapes, and one library call as a yardstick where there is one
   (``F.scaled_dot_product_attention``, cuDNN's grouped ``F.conv2d``, the
   unfused cuDNN bottlenecks): timed here, used nowhere on the kernels' paths.
   The depthwise kernel is timed at ConvNeXt-T's k 7 shapes and, as an entry
   of its own, at EfficientNet-B4's and MobileNetV3-Small's k 3 and 5 shapes,
   with the host's time a launch beside cuDNN's. The flash kernel is also timed
   through ``flash_attention_qkv`` beside the copies it replaced, with the
   host's time per launch. The window-attention kernel is timed as Swin
   serves it, through ``window_attention_qkv`` on the qkv product, beside the
   4-D entry with the roll, partition, copies and merge it replaced.
4b. The ``bf16_exp`` variant's own path, ``tools.bench_vit_attn``, with the
   launch counts set to 0 before and read after.
5. ViT-B/16 @384 at full width (random weights from seed 0) in this
   process: the bf16 forward through the kernel against the fp32 forward
   through the plain version.
5b. ResNet-50 at full width in this process: bf16 with fused chains against
   the fp32 unfused forward, beside the bf16 unfused (cuDNN) forward; then
   one bucket-32 engine step with the chains on and off.
5c. ConvNeXt-T, Swin-T, MobileNetV3-Small and EfficientNet-B4 at full width
   in this process: bf16 through the kernels against the fp32 forward through
   the plain versions, beside the bf16 forward with cuDNN's grouped
   convolution or the plain window attention; then one bucket-32 engine step
   of each, kernels on and off.
5d. The device-decode lane: the port's entropy decoder built (``g++``) and
   timed per image beside PIL's full decode on a seeded corpus (4:2:0,
   4:2:2, 4:4:4, gray; baseline, progressive, restart markers; 224x224,
   500x375, 1000x750); each mode's device-decoded canvas against PIL (mean
   under 1, max at most 6, gray 2) and the fp32 coefficient step against the
   pixel step fed that canvas (top-1 equal, scores within 1e-4); the
   ResNet-50 bf16 coefficient and pixel steps at buckets 1, 8 and 32 with the
   bytes each lane sends; the decode alone at bucket 32 beside its bound,
   with the kernels it launches (both from ``tools.bench_decode``). Then
   restart segments on worker threads: restart-marker JPEGs (one restart an
   MCU row, q90, each sampling mode, 1000x750 and 2048x1536) decoded on 1,
   2, 4 and 8 threads give the serial decode's bytes, the threads taken on
   every file of at least ``MT_MIN_BYTES``; us per image at each thread
   count beside PIL.
5e. DenseNet-121/169 and RegNet-Y 400MF/1.6GF at full width in this process
   (random weights from seed 0; no kernel of the port is on their paths):
   bf16 against fp32 logits on eight seeded images (top-1 equal where the
   fp32 margin exceeds twice the largest deviation), bf16 engine steps at
   buckets 1, 8 and 32 by CUDA events with the kernels a bucket-32 step
   launches by ``torch.profiler`` and where their time goes, DenseNet's
   served ``torch.cat`` per layer in turns with a buffer a dense block; then the
   pretrained import on the card: the port's ``save_npz`` of a seeded
   ``regnet_y_400mf`` and ``densenet121`` through ``load_pretrained`` into
   an fp32 engine gives the seeded engine's logits exactly.
6. The main paths: one ``python -m ics_tpu_torch.main`` whose default model
   is ResNet-50 with ``TPU_FUSED_CHAINS=true`` and ``TPU_DEVICE_DECODE`` at
   its default (on, so JPEGs take the device-decode lanes; PNGs and larger
   JPEGs the pixel lane), classify requests over HTTP:
   JPEGs to ResNet-50, the same JPEGs to ``?modelo=vit_b16`` (the pool
   builds it), a batch of 384x384 PNGs to ViT-B/16 (the fixed-size lane),
   then JPEGs to ``?modelo=convnext_tiny``, ``?modelo=swin_tiny`` and
   ``?modelo=mobilenetv3_small``. The kernel launch counts are set to 0 just
   before each stretch and read just after, and every kernel of that
   stretch's path must have run: ``depthwise_conv`` 18 times a batch on
   ConvNeXt-T and 7 times on MobileNetV3-Small, ``window_attention`` 12
   times a batch on Swin-T. Every JPEG stretch must answer ``device:<mode>``;
   a last stretch sends a JPEG of each (mode, luma bucket), a PNG and a JPEG
   over 1024 px, and reads each lane's flushes and the device-decode gauges
   of ``/monitor/metrics``. The stretches start once the lanes' background
   warm-up has ended. The server runs with ``TPU_DECODE_THREADS=4``; then
   four PNGs, one a request, to each of ``?modelo=densenet121`` and
   ``?modelo=regnet_y_1_6gf`` (no kernel of the port launched; top-5 and
   scores against this process's engine), and a 1000x750 restart-marker JPEG
   of at least ``MT_MIN_BYTES`` to ResNet-50, whose entropy decode must take
   the threads (``entropy_threaded_scans`` of the status) and whose answer
   must equal this process's coefficient step on the serial decode.
7. The ingestion front: a second ``python -m ics_tpu_torch.main`` (the same
   ResNet-50 configuration) with ``NEXTCLOUD_BASE_URL`` on the port's fake
   NextCloud (``tools/fake_nextcloud.py``, two folders: 96 JPEGs of 64-512
   px in every sampling mode, some progressive, 4 PNGs, 2 JPEGs over 1024
   px), ``TPU_CLASSIFY_ON_SYNC``, ``TPU_EMBED_ON_SYNC`` and the initial sync
   at startup. The fake answers nothing until its gate opens, which happens
   once the lanes' warm-up has ended and the launch counts are 0; the phase
   then times the sync until every image has its one ``resnet50``
   suggestion and its 2048-wide embedding, and checks: each suggestion
   against ``POST /inferencia/classificar`` on the same bytes; each stored
   embedding's norm and its cosine with the fp32 plain path in this
   process; ``bottleneck_chain`` launches = 5 x (classify flushes + embed
   steps); ``/images/{hash}/similares`` against an fp32 ranking of the
   stored vectors; a q75 re-encode found by ``/images/buscar-similares``;
   a ``sugerir-vizinhos`` vote stored as ``knn:resnet50``; ``/monitor/status``.
8. The serving extras. (a) The two backward passes of the explain step
   against autograd of their plain versions: ``window_attention_qkv_bwd``
   (``csrc/window_attention_bwd.cu``) at every Swin-T call at batch 1 and 16,
   bf16 and fp32, NaN behind the batch; ``depthwise_conv_dx`` (the depthwise
   kernel on flipped taps, through autograd of the served ``Conv2D``) at
   every depthwise call of ConvNeXt-T, EfficientNet-B4 and MobileNetV3-Small
   at batch 16, bf16 and fp32, NaN around dy; the largest error at most 1e-4
   (fp32) and 2e-2 (bf16) of the largest gradient, each case twice; then
   both timed at the calls of one explain step at a SmoothGrad batch of 16
   beside their plain versions, their bounds and their yardsticks (SDPA's
   autograd backward with ``attn_mask``, replayed from a CUDA graph;
   ``torch.nn.grad.conv2d_input``), and the depthwise input gradient also
   at EfficientNet-B4's 28 and MobileNetV3-Small's 7 k 3/5 calls (in the
   log; the kernels line keeps ConvNeXt-T's). (b) ``explain_staged`` at
   full width in this process, kernel path against the same engine's plain
   path: ConvNeXt-T, Swin-T, EfficientNet-B4, fp32 and bf16, n = 1 and 16;
   top-5 equal, fp32 heat maps within 1e-3, bf16 at a cosine of at least
   0.99, forward and backward kernels launched once a layer; ViT-B/16 and
   ResNet-50 with fused chains raise ``KernelHasNoGradient``; EfficientNet-B4's
   bf16 step at n = 16 timed in turns, kernel path and plain path. (c) A third
   ``python -m ics_tpu_torch.main`` serving ConvNeXt-T in fp32:
   ``classificar-tpu`` and ``?tta=true`` (scores against the mean of the
   image's and its flip's probabilities in this process, 1e-3),
   ``explicar?suavizar=8`` (a 16x16 grid in [0, 1]); a trained Swin-T version
   written with the port's ``CheckpointManager`` (3 options, weights from
   seed 1, temperature 2) through both routes (scores against softmax(logits
   / 2) of the plain fp32 forward, 1e-3), version 2 promoted and version 1
   stopped; ``POST /monitor/latency-budget`` within its ``cuda`` lines; each
   stretch with the launch counts set to 0 before it and read after it.

Prints ``{"kernels": [...]}`` on the line before the last and
``{"ok": true, "device": {...}}`` as the last line. Exits non-zero, with no
result, when no CUDA device is visible, when the package is not beside the
script, or when any phase fails.
"""

from __future__ import annotations

import asyncio
import contextlib
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
# depthwise_conv: the kernel and the plain version sum the same k*k fp32
# products in another order. In fp32 that is a few ulps of the largest output;
# in bf16 the one rounding may fall on the other side of a tie: one bf16 ulp
# of the largest output, 2^-5 for |y| < 8 (the cases keep |y| < 8).
DW_BF16_TOL = 2.0 ** -5
# flash attention with bf16_exp: each p is within 2^-7 relative of the plain
# version's (the bound of ex2.approx.ftz.bf16x2), on top of the bf16 bar.
BF16_EXP_TOL = 2e-2
VIT = "vit_b16"
RESNET = "resnet50"
CONVNEXT = "convnext_tiny"
SWIN = "swin_tiny"
MOBILENET = "mobilenetv3_small"
EFFICIENTNET = "efficientnet_b4"
CONVNEXT_DEPTHS = (3, 3, 9, 3)   # ConvNeXt-T: one depthwise_conv launch per block, 18
SWIN_DEPTHS = (2, 2, 6, 2)       # Swin-T: one window_attention launch per block, 12
MOBILENET_LAUNCHES = 7           # MobileNetV3-Small: its stride-1 blocks, 7 of 11
VIT_DEPTH = 12              # ViT-B/16: one flash launch per block per batch
CHAIN_LAUNCHES = 5          # ResNet-50: one launch per chained bottleneck, 2 + 3
SERVER_START_S = 600
SERVER_BUCKETS = (1, 8, 32)  # TPU_BATCH_BUCKETS of phase 6's server
MT_MIN_BYTES = 96 * 1024     # native.imgcodec's: smaller files are entropy-decoded serially
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


_AHEAD: dict = {}


def cuda_ms(fn, iters: int, ahead: bool = True) -> float:
    """ms per call by CUDA events. ``ahead``: a few milliseconds of other work
    (two 8192^2 bf16 products) go to the device first, so that the host has
    queued every launch by the time the first one starts and a kernel shorter
    than its launch overhead is still timed on the device's clock. An engine
    step is timed without it: there the host's pace is part of the step."""
    import torch

    if ahead:
        if "a" not in _AHEAD:
            _AHEAD["a"] = torch.ones((8192, 8192), device="cuda", dtype=torch.bfloat16)
        for _ in range(2):
            torch.mm(_AHEAD["a"], _AHEAD["a"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_case(torch, attention, shape, dtype, seq_len, layout: str,
                   bf16_exp: bool = False) -> float:
    """One phase-3 case of the flash kernel, run twice; returns its error.

    ``layout`` "contiguous": q, k, v are [B, H, S, D] tensors of their own.
    "qkv": they are strided views of one [B + 1, S, 3, H, D] tensor, as ViT's
    fused product lies, and the result also goes through
    ``flash_attention_qkv``; the image behind the last one is NaN. In both
    layouts the K and V rows at or past ``seq_len`` are NaN: the kernel must
    never read them, and a zero weight times NaN would show. The plain
    version gets contiguous copies with those rows zeroed."""
    b, h, s, d = shape
    g = torch.Generator(device="cuda").manual_seed(s * 131 + d)
    if layout == "qkv":
        store = torch.randn((b + 1, s, 3, h, d), generator=g, device="cuda").to(dtype)
        store[b:] = float("nan")
        qkv = store[:b]
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
    clean_k, clean_v = k.clone().contiguous(), v.clone().contiguous()
    if seq_len is not None:
        k[:, :, seq_len:] = float("nan")
        v[:, :, seq_len:] = float("nan")
        clean_k[:, :, seq_len:] = 0
        clean_v[:, :, seq_len:] = 0
    ref = attention.attention_reference(q.contiguous(), clean_k, clean_v, seq_len, bf16_exp)
    tol = (BF16_EXP_TOL if bf16_exp else BF16_TOL) if dtype == torch.bfloat16 else FP32_TOL
    runs = []
    for _ in range(2):   # a missing fence shows only sometimes
        runs.append(attention.flash_attention(q, k, v, seq_len, bf16_exp))
        if layout == "qkv":
            runs.append(attention.flash_attention_qkv(qkv, seq_len, bf16_exp).transpose(1, 2))
    torch.cuda.synchronize()
    err = max((out.float() - ref.float()).abs().max().item() for out in runs)
    finite = all(bool(torch.isfinite(out).all()) for out in runs)
    same = all(torch.equal(out, runs[0]) for out in runs[1:])
    zeros = all(bool((out == 0).all()) for out in runs) if seq_len == 0 else None
    log(f"  flash_attention{' bf16_exp' if bf16_exp else ''} {list(shape)} {str(dtype)[6:]} "
        f"{layout} seq_len={seq_len}: max_abs_err={err:.3e} (tol {tol:g})"
        + ("" if zeros is None else f" exact_zeros={zeros}"))
    if not finite or not (err <= tol) or not same or zeros is False:
        fail(f"flash_attention{' (bf16_exp)' if bf16_exp else ''} disagrees with its plain "
             f"version at {shape} {dtype} {layout} seq_len={seq_len}: err {err}, finite "
             f"{finite}, every run and entry point the same {same}")
    return err


def check_attention(torch, attention) -> float:
    """Phase 3: kernel against plain version; returns the largest error.
    Tolerances: bf16 1e-2 (outputs are O(1); one bf16 ulp at 1.0 is 7.8e-3),
    fp32 1e-5 (the same fp32 math summed in another order)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [((8, 12, 577, 64), bf16, None, "contiguous"),       # the serving shape
             ((8, 12, 577, 64), bf16, None, "qkv"),
             ((8, 12, 577, 64), fp32, None, "contiguous"),
             ((8, 12, 577, 64), fp32, 300, "qkv")]
    # S on both sides of the 64-row and 128-key tile edges
    for i, s in enumerate((1, 63, 64, 65, 127, 128, 129, 577, 1100)):
        layout = ("contiguous", "qkv")[i % 2]
        cases.append(((2, 3, s, 64), bf16, None, layout))
        cases.append(((1, 2, s, 128), bf16, None, ("qkv", "contiguous")[i % 2]))
    # masked keys: none valid, one, a ragged tile, all; NaN behind seq_len
    for d in (64, 128):
        for seq_len in (0, 1, 300, 577):
            cases.append(((2, 3, 577, d), bf16, seq_len, "qkv"))
    cases += [((2, 12, 577, 64), bf16, 300, "contiguous"),
              ((1, 12, 1100, 64), fp32, 0, "contiguous"),
              ((2, 3, 130, 16), bf16, None, "contiguous"),     # the mma.sync kernel
              ((2, 3, 130, 16), bf16, 70, "qkv"),
              ((2, 3, 130, 32), bf16, None, "qkv"),
              ((2, 3, 63, 32), bf16, 1, "contiguous"),
              ((2, 3, 130, 128), fp32, None, "qkv"),
              ((2, 3, 65, 16), fp32, 64, "contiguous")]
    return max(attention_case(torch, attention, *case) for case in cases)


def in_turns(label: str, kernel, plain, iters: int = 20,
             ahead: bool = True) -> tuple[float, float]:
    """ms per call of a kernel and its plain version, in turns (kernel,
    plain, plain, kernel) after a warm-up of each."""
    for fn in (kernel, plain):
        cuda_ms(fn, 3, ahead)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name].append(cuda_ms(kernel if name == "kernel" else plain, iters, ahead))
    ms, plain_ms = (sum(v) / len(v) for v in (runs["kernel"], runs["plain"]))
    log(f"  {label}: kernel {runs['kernel']} ms, plain {runs['plain']} ms; "
        f"mean {ms:.4f} vs {plain_ms:.4f} ms")
    return ms, plain_ms


def library_ms(fn, iters: int = 20) -> float:
    """ms per call of a library yardstick: the mean of two runs after a warm-up."""
    cuda_ms(fn, 3)
    return (cuda_ms(fn, iters) + cuda_ms(fn, iters)) / 2


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def host_us(fn, calls: int = 300) -> float:
    """The host's time per call, launches only (the device runs behind)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_attention(torch, attention, bf16_exp: bool = False) -> dict:
    """Phase 4: the flash kernel at the serving bucket's shape: on contiguous
    [B, H, S, D] (the table's row), through ``flash_attention_qkv`` on the
    fused product as ViT calls it, and beside that the three copies, the
    kernel and the output copy that ViT made before the kernel took strides."""
    import torch.nn.functional as F

    shape = (32, 12, 577, 64)
    b, h, s, d = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda").to(torch.bfloat16)
    views = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    q, k, v = (t.contiguous() for t in views)
    name = "flash_attention" + (" bf16_exp" if bf16_exp else "")
    ms, plain_ms = in_turns(
        f"{name} {list(shape)} bf16",
        lambda: attention.flash_attention(q, k, v, bf16_exp=bf16_exp),
        lambda: attention.attention_reference(q, k, v, bf16_exp=bf16_exp), iters=10)
    out = {"ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
           **bound(4 * q.numel() * 2, 4.0 * b * h * s * s * d, BF16_FLOPS)}
    log(f"    F.scaled_dot_product_attention (yardstick only) {out['library_ms']:.4f} ms; "
        f"bound {out['bound_ms']:.4f} ms by {out['bound_by']}")
    if bf16_exp:
        return out

    def with_copies():
        cq, ck, cv = (t.contiguous() for t in views)
        return attention.flash_attention(cq, ck, cv).transpose(1, 2).reshape(b, s, h * d)

    qkv_ms, copies_ms = in_turns(
        f"{name}_qkv on [32, 577, 3, 12, 64] (kernel) beside q/k/v copies + kernel + output "
        "copy (under 'plain')",
        lambda: attention.flash_attention_qkv(qkv), with_copies)
    strided_sdpa = library_ms(lambda: F.scaled_dot_product_attention(*views))
    small = torch.randn((1, 128, 3, 12, 64), generator=g, device="cuda").to(torch.bfloat16)
    log(f"    F.scaled_dot_product_attention on the strided views (yardstick only) "
        f"{strided_sdpa:.4f} ms; host time a launch, tensor maps included, "
        f"{host_us(lambda: attention.flash_attention_qkv(small)):.1f} us")
    return {**out, "qkv_ms": qkv_ms, "copies_and_kernel_ms": copies_ms}


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
    """Phase 3: bottleneck_chain against its plain version; the largest error.
    The tiling depends on the batch, so both ResNet-50 chains run at each of
    the server's buckets, with the tile rows and ring stages that the wrapper
    takes there in the log. Every case runs twice and must come out equal bit
    for bit."""
    # shape, Cm, N, tile_rows (None: the wrapper's own), large bias
    cases = [((bucket, *shape), cm, n, None, False)
             for bucket in SERVER_BUCKETS
             for shape, cm, n in (((56, 56, 256), 64, 2),     # ResNet-50 stage 0
                                  ((28, 28, 512), 128, 3))]   # ResNet-50 stage 1
    cases += [
        ((2, 7, 7, 256), 64, 2, None, False),       # a whole image in one tile, H*W = 49 < an M tile
        ((1, 14, 14, 1024), 256, 1, None, False),   # the widest inner width
        ((3, 9, 13, 256), 64, 1, None, False),      # H*W = 117: no multiple of 64 or of 128
        ((2, 14, 14, 512), 128, 2, 4, False),       # TH 4 on H 14: a short last tile of 2 rows
        ((2, 30, 20, 256), 64, 3, 7, False),        # TH 7 on H 30: last tile 2 rows, 5 passes
        ((1, 10, 9, 1024), 256, 2, 3, False),       # Cm 256 with a short last tile
        ((2, 12, 12, 256), 64, 2, 5, True),         # relu(b1) on the zero ring would show
    ]
    worst = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, cm, n, tile_rows, big_bias in cases:
        packed = make_chain(torch, n, shape[-1], cm, seed=3 if big_bias else 0)
        if big_bias:
            packed["b1"] = packed["b1"] + 2.0
            packed["w2"] = (packed["w2"].float() * 0.3).bfloat16()
        x = chain_input(torch, shape, seed=1)
        ref = bottleneck.bottleneck_chain_reference(x, packed)
        top = ref.float().abs().max().item()
        runs = [bottleneck.bottleneck_chain(x, packed, tile_rows=tile_rows) for _ in range(2)]
        torch.cuda.synchronize()
        diff = (runs[0].float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        same = torch.equal(runs[0], runs[1])
        th = tile_rows or bottleneck.pick_tile_rows(*shape[1:3], cm, shape[0], sms)
        took = (f"tile_rows={th}{'' if tile_rows else ' (its own)'} "
                f"stages={bottleneck.ring_stages(th, shape[2], cm)}")
        log(f"  bottleneck_chain {list(shape)} Cm={cm} N={n} {took}"
            f"{' large bias' if big_bias else ''} bf16: max_abs_err={err:.3e} (tol "
            f"{CHAIN_TOL:g}), mean {mean:.2e} (tol {CHAIN_MEAN_TOL:g}), max|y|={top:.2f}, "
            f"twice the same {same}")
        if not bool(torch.isfinite(runs[0]).all()) or top >= 4 or err > CHAIN_TOL \
                or mean > CHAIN_MEAN_TOL or not same:
            fail(f"bottleneck_chain disagrees with its plain version at {shape} "
                 f"Cm={cm} N={n} tile_rows={tile_rows}: err {err}, mean {mean}, max|y| "
                 f"{top}, twice the same {same}")
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
    """Phase 4: both ResNet-50 chains of one bucket-32 step (5 launches). The
    library yardstick is what the chains replace: the same bottlenecks as
    ``Bottleneck.apply_folded``, cuDNN convolutions with scale, bias, ReLU and
    the shortcut as PyTorch ops between them (another rounding, so it is
    timed, not compared)."""
    from torch import nn

    from ics_tpu_torch.models.resnet import Bottleneck
    from ics_tpu_torch.nn.blocks import fold_convbn
    from ics_tpu_torch.nn.layers import reset_all_parameters

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    n_bytes = n_ops = 0.0
    for shape, cm, n in [((32, 56, 56, 256), 64, 2), ((32, 28, 28, 512), 128, 3)]:
        c = shape[-1]
        blocks = nn.ModuleList([Bottleneck(c, cm) for _ in range(n)])
        reset_all_parameters(blocks, torch.Generator().manual_seed(0))
        fold_convbn(blocks)
        blocks = blocks.to(device="cuda", dtype=torch.bfloat16).eval()
        packed = bottleneck.ChainWeights(bottleneck.pack_chain_weights(blocks)).cuda()
        x = chain_input(torch, shape, seed=1)

        def unfused():
            y = x
            for blk in blocks:
                y = blk.apply_folded(y)
            return y

        with torch.inference_mode():
            ms, plain_ms = in_turns(
                f"bottleneck_chain {list(shape)} Cm={cm} N={n} bf16",
                lambda: bottleneck.bottleneck_chain(x, packed),
                lambda: bottleneck.bottleneck_chain_reference(x, packed), iters=10)
            lib = library_ms(unfused, iters=10)
            small = x[:1].contiguous()
            host = host_us(lambda: bottleneck.bottleneck_chain(small, packed)) / n
        # x read once, the output written once, the weights read once; per
        # pixel and bottleneck 2 * (C*Cm + 9*Cm*Cm + Cm*C) operations
        case_bytes = 2 * x.numel() * 2 + sum(
            v.numel() * v.element_size() for v in packed.packed().values())
        case_ops = 2.0 * n * (x.numel() // c) * (2 * c * cm + 9 * cm * cm)
        b = bound(case_bytes, case_ops, BF16_FLOPS)
        log(f"    {case_bytes / 1e6:.1f} MB, {case_ops / 1e9:.1f} GFLOP: bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}; {case_ops / ms / 1e9:.1f} TFLOP/s; "
            f"host {host:.1f} us a launch")
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib)):
            total[key] += value
        n_bytes += case_bytes
        n_ops += case_ops
    log(f"    both chains: kernel {total['ms']:.4f} ms, "
        f"cuDNN blocks {total['library_ms']:.4f} ms")
    return {**total, **bound(n_bytes, n_ops, BF16_FLOPS)}


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


def check_bf16_exp(torch, attention) -> float:
    """Phase 3: flash_attention(bf16_exp=True) against its plain version, which
    walks the kernel's key tiles. Tolerance 2e-2: each p is within 2^-7
    relative of the plain version's (the bound of ex2.approx.ftz.bf16x2), on
    top of the bf16 bar."""
    bf16 = torch.bfloat16
    cases = [((8, 12, 577, 64), bf16, None, "qkv"), ((8, 12, 577, 64), bf16, 300, "contiguous"),
             ((1, 12, 1100, 64), bf16, None, "contiguous"), ((2, 3, 577, 128), bf16, 300, "qkv"),
             ((2, 3, 129, 128), bf16, None, "contiguous"), ((2, 3, 130, 32), bf16, 0, "qkv"),
             ((2, 3, 130, 16), bf16, 65, "contiguous"), ((2, 3, 64, 64), bf16, 1, "qkv")]
    return max(attention_case(torch, attention, *case, bf16_exp=True) for case in cases)


def depthwise_inputs(torch, shape, k: int, bias: bool, dtype, seed: int = 0,
                     scale: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    x = (scale * torch.randn(shape, generator=g)).to(dtype).cuda()
    w = (torch.randn((k, k, shape[-1]), generator=g) / k).to(dtype).cuda()
    b = torch.randn(shape[-1], generator=g).to(dtype).cuda() if bias else None
    return x, w, b


CONVNEXT_SHAPES = [(56, 96), (28, 192), (14, 384), (7, 768)]   # (H = W, C) per stage


def depthwise_case(torch, depthwise, shape, k, bias, dtype, layout="kkc", variant=None,
                   geometry=None, scale=1.0) -> float:
    """One phase-3 case of depthwise_conv, run twice; returns its error. x is
    the middle of a larger tensor of NaN: a kernel that read a value outside x
    into a result would show it. ``layout``: the weight as [k, k, C] or as a
    module's OIHW in channels_last memory."""
    x, w, b = depthwise_inputs(torch, shape, k, bias, dtype, scale=scale)
    store = torch.full((shape[0] + 2, *shape[1:]), float("nan"), dtype=dtype, device="cuda")
    store[1:-1] = x
    x = store[1:-1]
    if layout == "oihw":
        w = w.permute(2, 0, 1).reshape(shape[-1], 1, k, k).contiguous(
            memory_format=torch.channels_last)
    runs = [depthwise.depthwise_conv(x, w, b, variant=variant, geometry=geometry)
            for _ in range(2)]
    torch.cuda.synchronize()
    ref = depthwise.depthwise_reference(x, w, b)
    top = ref.float().abs().max().item()
    tol = DW_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL * max(top, 1.0)
    err = (runs[0].float() - ref.float()).abs().max().item()
    same = torch.equal(runs[0], runs[1])
    took = variant
    if took is None:     # what the wrapper takes on its own, with the strip kernel's geometry
        took, plan = depthwise.pick_plan(*shape, k, x.element_size())
        took += "" if plan is None else f" {plan}"
    log(f"  depthwise_conv {took}{'' if geometry is None else ' ' + str(geometry)} {list(shape)} "
        f"k={k} bias={bias} {layout} {str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol:.3g}), "
        f"max|y|={top:.2f}")
    if not bool(torch.isfinite(runs[0]).all()) or top >= 8 or not (err <= tol) or not same:
        fail(f"depthwise_conv ({took}) disagrees with its plain version at {shape} k={k} "
             f"bias={bias} {layout} {dtype} geometry {geometry}: err {err}, max|y| {top}, "
             f"twice the same {same}")
    return err


def check_depthwise(torch, depthwise) -> dict:
    """Phase 3: depthwise_conv against its plain version; the largest error
    at k 7 and at k 3 and 5. Every depthwise call of ConvNeXt-T,
    MobileNetV3-Small and EfficientNet-B4 at each of the server's buckets (the
    kernel and its geometry depend on the batch; the plan taken is in the
    log), then shapes on both sides of the strip kernel's block edges (with the thread shape and the block
    geometry named, so that the edges are where the case says), H and W
    smaller than k, C of 8, 24, 40, 88 and an odd C and k 9 (the direct
    kernel), the tile kernel; bias and none, bf16 and fp32, both weight layouts."""
    bf16, fp32 = torch.bfloat16, torch.float32
    worst = {3: 0.0, 5: 0.0, 7: 0.0, 9: 0.0}

    def case(shape, k, bias, dtypes=(bf16, fp32), **kw):
        for dtype in dtypes:
            worst[k] = max(worst[k], depthwise_case(torch, depthwise, shape, k, bias, dtype, **kw))

    from ics_tpu_torch.tools.bench_depthwise import depthwise_calls

    for model in (CONVNEXT, MOBILENET, EFFICIENTNET):
        for bucket in SERVER_BUCKETS:
            for shape, k, bias in sorted(depthwise_calls(model, bucket)):
                # halved: among tens of millions of outputs of unit deviation one passes 8
                case(shape, k, bias, (bf16,), scale=0.5)
    for hw, c in CONVNEXT_SHAPES:
        case((8, hw, hw, c), 7, True, (fp32,))
    case((8, 28, 28, 88), 3, False, layout="oihw")     # MobileNetV3-Small
    case((8, 14, 14, 240), 5, True)
    case((8, 14, 14, 240), 5, False, layout="oihw")
    case((4, 12, 12, 2688), 5, False)                  # EfficientNet-B4's widest
    case((4, 24, 24, 672), 3, False)
    case((2, 190, 190, 24), 3, False, layout="oihw")   # and its largest image: 3 units a pixel
    case((8, 7, 7, 576), 5, False)
    case((16, 1, 1, 96), 3, True)                      # a 1x1 image: only the centre tap lands
    case((2, 10, 6, 15), 3, True)                      # an odd C: the direct kernel
    case((1, 11, 11, 32), 9, True)                     # k 9: the direct kernel
    # W and H one under, at and one over a block of 8 rows by 8 columns (7 where
    # a thread has 7 columns), with the wide and the narrow thread shape
    for k in (3, 5, 7):
        for dtype in (bf16, fp32):
            itemsize = 2 if dtype == bf16 else 4
            for ch, cols in depthwise.STRIP_SHAPES[(itemsize, k)]:
                tw = max(8 // cols, 1)
                edge = tw * cols
                for h, w in ((7, edge + 1), (8, edge), (9, edge - 1)):
                    case((2, h, w, 8), k, h == 8, (dtype,), variant="strip",
                         geometry=(ch, cols, 8 // ch, tw, 8))
    # H and W smaller than k; C 24, 40, 88 with a last channel block that is part empty
    case((3, 2, 3, 24), 7, True)
    case((3, 3, 2, 40), 5, False, layout="oihw")
    case((2, 9, 11, 88), 3, True, (bf16,), variant="strip", geometry=(8, 1, 8, 11, 5))
    case((2, 9, 11, 88), 3, True, (bf16,), variant="strip", geometry=(4, 4, 16, 3, 5))
    case((2, 9, 11, 40), 7, True, (bf16,), variant="strip", geometry=(2, 1, 16, 4, 9))
    case((2, 9, 11, 40), 7, True, (bf16,), variant="strip", geometry=(1, 7, 32, 2, 9))
    case((5, 9, 11, 24), 5, False, variant="strip", geometry=(4, 1, 6, 11, 9))
    case((5, 9, 11, 24), 5, False, variant="strip", geometry=(2, 4, 12, 3, 9))
    case((5, 6, 6, 40), 7, True, (bf16,), variant="strip", geometry=(2, 1, 20, 6, 6))
    for k in (3, 5, 7):                                # the tile kernel: serves the small calls
        case((4, 14, 20, 48), k, True, variant="tile")
    case((2, 60, 60, 96), 7, True)                     # k 7 on a wide image, a few images
    case((16, 56, 56, 96), 7, True, (bf16,))           # and enough of them for the wide threads
    case((16, 24, 24, 672), 3, False, (bf16,))
    case((16, 24, 24, 960), 5, False, (bf16,))
    return {"k7": worst[7], "k35": max(worst[3], worst[5])}


def window_inputs(torch, batch: int, grid: int, heads: int, hd: int, window: int,
                  masked: bool, dtype, seed: int = 0):
    """q (pre-scaled), k, v, bias and the model's own shift mask for one
    Swin stage: ``grid`` tokens a side in windows of ``window``."""
    from ics_tpu_torch.models.swin import _shift_attn_mask

    ww = window * window
    n_w = (grid // window) ** 2
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((batch * n_w, heads, ww, hd), generator=g).to(dtype).cuda()
               for _ in range(3))
    q = q * hd ** -0.5
    bias = torch.randn((heads, ww, ww), generator=g).cuda()
    mask = None
    if masked:
        mask = torch.from_numpy(_shift_attn_mask(grid, window, window // 2)).cuda()
    return q, k, v, bias, mask


SWIN_STAGES = [(56, 3), (28, 6), (14, 12), (7, 24)]   # (grid, heads) per stage; window 7, hd 32


def qkv_inputs(torch, batch: int, grid: int, heads: int, hd: int, window: int, shift: int,
               dtype, seed: int = 0):
    """The qkv product [B, G, G, 3, H, hd] as Swin's qkv GEMM leaves it, a view
    of one with an image of NaN behind the last one (a window of this batch
    that read it would show it), Swin's fp32 table, int16 index and shift mask."""
    from ics_tpu_torch.models.swin import _relative_position_index, _shift_attn_mask

    g = torch.Generator().manual_seed(seed)
    store = torch.randn((batch + 1, grid, grid, 3 * heads * hd), generator=g).to(dtype).cuda()
    store[batch:] = float("nan")
    qkv = store[:batch].unflatten(-1, (3, heads, hd))
    table = torch.randn(((2 * window - 1) ** 2, heads), generator=g).cuda()
    index = torch.from_numpy(_relative_position_index(window)).to(torch.int16).cuda()
    mask = torch.from_numpy(_shift_attn_mask(grid, window, shift)).cuda() if shift else None
    return qkv, table, index, mask


def qkv_plan(torch, window_attention, qkv, table, window, masked) -> str:
    """The heads a work item takes that the wrapper picks for this call."""
    if qkv.dtype != torch.bfloat16:
        return "fp32 SIMT, a block a (window, head)"
    b, grid, _, _, heads, hd = qkv.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    group = window_attention.pick_head_group(
        b * (grid // window) ** 2, heads, window * window, hd, table.shape[0], masked, sms)
    return f"head_group={group}"


def check_window(torch, window_attention) -> float:
    """Phase 3: both entries against their plain versions; the largest error.
    ``window_attention`` on [Bn, H, ww, hd] at Swin-T's stages and
    swin_micro's; ``window_attention_qkv`` at every Swin-T call at each of
    the server's buckets (the plan depends on the batch; it is in the log),
    the windows of shifted blocks wrapping round the image's edge, swin_micro's
    ww 16 / hd 16, ww 25 and 9 (no multiple of 8), ww 64, with NaN in the
    image behind the batch. Every case runs twice and must come out equal bit
    for bit."""
    worst = 0.0

    def judge(label, runs, ref, tol):
        nonlocal worst
        err = (runs[0].float() - ref.float()).abs().max().item()
        same = torch.equal(runs[0], runs[1])
        log(f"  {label}: max_abs_err={err:.3e} (tol {tol:g}), twice the same {same}")
        if not bool(torch.isfinite(runs[0]).all()) or not (err <= tol) or not same:
            fail(f"{label} disagrees with its plain version: err {err}, twice the same {same}")
        worst = max(worst, err)

    cases = [(8, grid, heads, 32, 7, masked)
             for grid, heads in SWIN_STAGES for masked in (False, True) if masked <= (grid > 7)]
    cases += [(8, 16, 2, 16, 4, True), (8, 8, 4, 16, 4, False)]   # swin_micro: ww 16, hd 16
    for batch, grid, heads, hd, window, masked in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = window_inputs(torch, batch, grid, heads, hd, window, masked, dtype)
            runs = [window_attention.window_attention(*args) for _ in range(2)]
            torch.cuda.synchronize()
            judge(f"window_attention {list(args[0].shape)} mask={masked} {str(dtype)[6:]}",
                  runs, window_attention.window_attention_reference(*args),
                  BF16_TOL if dtype == torch.bfloat16 else FP32_TOL)

    from ics_tpu_torch.tools.bench_window import swin_calls

    qkv_cases = [(bucket, grid, heads, hd, window, shift, torch.bfloat16)
                 for bucket in SERVER_BUCKETS
                 for grid, heads, shift, _, window, hd in swin_calls("swin_tiny")]
    qkv_cases += [(8, grid, heads, hd, window, shift, torch.float32)
                  for grid, heads, shift, _, window, hd in swin_calls("swin_tiny")]
    for dtype in (torch.bfloat16, torch.float32):
        qkv_cases += [(8, 16, 2, 16, 4, 2, dtype), (8, 8, 4, 16, 4, 0, dtype),  # swin_micro
                      (3, 10, 2, 16, 5, 2, dtype), (2, 9, 2, 32, 3, 1, dtype),   # ww 25, 9
                      (2, 16, 1, 32, 8, 4, dtype)]                               # ww 64
    for batch, grid, heads, hd, window, shift, dtype in qkv_cases:
        qkv, table, index, mask = qkv_inputs(torch, batch, grid, heads, hd, window, shift, dtype)
        runs = [window_attention.window_attention_qkv(qkv, table, index, mask, window, shift,
                                                      hd ** -0.5) for _ in range(2)]
        torch.cuda.synchronize()
        ref = window_attention.window_attention_qkv_reference(qkv, table, index, mask, window,
                                                              shift, hd ** -0.5)
        plan = qkv_plan(torch, window_attention, qkv, table, window, shift > 0)
        judge(f"window_attention_qkv {list(qkv.shape)} window={window} shift={shift} "
              f"{str(dtype)[6:]} ({plan})", runs, ref,
              BF16_TOL if dtype == torch.bfloat16 else FP32_TOL)
    return worst


def time_depthwise(torch, depthwise) -> dict:
    """Phase 4: the 18 depthwise convolutions of one ConvNeXt-T bucket-32 step
    (7x7, bias; 3, 3, 9, 3 launches at the four stage shapes). The library
    yardstick is cuDNN's grouped convolution on channels_last bf16."""
    import torch.nn.functional as F

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by = set()
    for (hw, c), count in zip(CONVNEXT_SHAPES, CONVNEXT_DEPTHS):
        shape = (32, hw, hw, c)
        x, w, b = depthwise_inputs(torch, shape, 7, True, torch.bfloat16)
        ms, plain_ms = in_turns(
            f"depthwise_conv {list(shape)} k=7 bias bf16",
            lambda: depthwise.depthwise_conv(x, w, b),
            lambda: depthwise.depthwise_reference(x, w, b))
        x_nchw = x.permute(0, 3, 1, 2)                       # channels_last memory
        w_oihw = w.permute(2, 0, 1).reshape(c, 1, 7, 7).contiguous(
            memory_format=torch.channels_last)
        lib = library_ms(lambda: F.conv2d(x_nchw, w_oihw, b, 1, 3, 1, c))
        # x read once, y written once, taps and bias read once; 2 * k * k
        # operations an output on bf16 operands, reckoned at the bf16 peak
        case = bound(2 * x.numel() * 2 + (w.numel() + b.numel()) * 2,
                     2.0 * 49 * x.numel(), BF16_FLOPS)
        log(f"    F.conv2d(groups=C) channels_last (yardstick only) {lib:.4f} ms; bound "
            f"{case['bound_ms']:.4f} ms by {case['bound_by']}; x{count} a step; served by "
            f"{depthwise.pick_variant(shape, 7, torch.bfloat16)}")
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                           ("bound_ms", case["bound_ms"])):
            total[key] += count * value
        by.add(case["bound_by"])
    # the step's bound is the sum of its launches' bounds; it is named after
    # the side most of them are on
    return {**total, "bound_by": "operations" if "operations" in by else "bytes"}


def time_depthwise_k35(torch, depthwise) -> dict:
    """Phase 4: the k 3 and k 5 depthwise convolutions of one bucket-32 step of
    EfficientNet-B4 (28) and of MobileNetV3-Small (7), through the module that
    serves them (``Conv2D``, its taps kept beside its weight), beside cuDNN's
    grouped convolution on the same module, with the host's time a launch of
    each."""
    from ics_tpu_torch.nn.layers import Conv2D
    from ics_tpu_torch.tools.bench_depthwise import depthwise_calls

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by = set()
    for model in (EFFICIENTNET, MOBILENET):
        step = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "launches": 0}
        for (shape, k, bias), count in sorted(depthwise_calls(model, 32).items()):
            c = shape[-1]
            conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
            conv.reset_parameters(torch.Generator().manual_seed(k))
            conv = conv.to(device="cuda", dtype=torch.bfloat16,
                           memory_format=torch.channels_last)     # as fold() stores it
            x, _, _ = depthwise_inputs(torch, shape, k, False, torch.bfloat16)
            cudnn = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=bias)
            cudnn.load_state_dict(conv.state_dict())
            cudnn = cudnn.to(device="cuda", dtype=torch.bfloat16,
                             memory_format=torch.channels_last)
            cudnn.use_kernel = False
            with torch.inference_mode():
                ms, plain_ms = in_turns(
                    f"depthwise_conv {list(shape)} k={k} bias={bias} bf16 ({model})",
                    lambda: conv(x), lambda: depthwise.depthwise_reference(x, conv.weight, conv.bias),
                    iters=10)
                lib = library_ms(lambda: cudnn(x))
                hosts = (host_us(lambda: conv(x)), host_us(lambda: cudnn(x)))
            case = bound(2 * x.numel() * 2 + (k * k + bias) * c * 2, 2.0 * k * k * x.numel(),
                         BF16_FLOPS)
            log(f"    cuDNN F.conv2d(groups=C) (yardstick only) {lib:.4f} ms; bound "
                f"{case['bound_ms']:.4f} ms by {case['bound_by']}; host {hosts[0]:.1f} us a "
                f"launch, cuDNN {hosts[1]:.1f}; x{count} a step")
            for key, value in (("ms", ms), ("library_ms", lib), ("bound_ms", case["bound_ms"])):
                step[key] += count * value
            by.add(case["bound_by"])
            total["plain_ms"] += count * plain_ms
            step["launches"] += count
        log(f"  {model}: {step['launches']} launches a step, kernel {step['ms']:.4f} ms, cuDNN "
            f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms")
        for key in ("ms", "library_ms", "bound_ms"):
            total[key] += step[key]
    return {**total, "bound_by": "operations" if "operations" in by else "bytes"}


def time_window(torch, window_attention) -> dict:
    """Phase 4: the 12 window attentions of one Swin-T bucket-32 step as Swin
    serves them, through ``window_attention_qkv`` on the qkv product, against
    its plain version (roll, partition, split, scale, attention, merge, roll)
    in turns; beside them the 4-D entry with the glue it needs, in turns with
    the qkv entry, and the host's time a launch. The library yardstick is
    ``F.scaled_dot_product_attention`` with bias + mask as ``attn_mask`` on
    the partitioned q, k, v (it leaves the glue out)."""
    import torch.nn.functional as F

    from ics_tpu_torch.tools import bench_window

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "glue_4d_ms": 0.0}
    with torch.inference_mode():
        for grid, heads, shift, count, window, hd in bench_window.swin_calls("swin_tiny"):
            call = bench_window.make_call(32, grid, heads, shift, window, hd)
            label = f"window_attention_qkv [32, {grid}, {grid}, 3, {heads}, 32] shift={shift} bf16"
            ms, plain_ms = in_turns(label, lambda: bench_window.qkv_entry(call),
                                    lambda: bench_window.plain(call))
            _, glue_ms = in_turns("  the same (kernel) beside the 4-D entry with its glue "
                                  "(under 'plain')", lambda: bench_window.qkv_entry(call),
                                  lambda: bench_window.glue_4d(call))
            attn_mask = bench_window.sdpa_mask(call)
            lib = library_ms(lambda: F.scaled_dot_product_attention(
                call["q"], call["k"], call["v"], attn_mask=attn_mask, scale=1.0))
            bound_ms = bench_window.bound_ms(call)
            small = bench_window.make_call(1, grid, heads, shift, window, hd)
            host = host_us(lambda: bench_window.qkv_entry(small))
            log(f"    F.scaled_dot_product_attention with attn_mask (yardstick only) "
                f"{lib:.4f} ms; bound {bound_ms:.4f} ms by bytes; head_group "
                f"{bench_window.head_group_of(call)}; host {host:.1f} us a launch; x{count} a step")
            for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                               ("bound_ms", bound_ms), ("glue_4d_ms", glue_ms)):
                total[key] += count * value
    log(f"    Swin-T's 12: qkv entry {total['ms']:.4f} ms, 4-D entry with its glue "
        f"{total['glue_4d_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, SDPA "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return {**total, "bound_by": "bytes"}


def drive_bf16_exp_path(torch) -> int:
    """Phase 4b: the bf16-exp variant's own path, ``tools.bench_vit_attn``, with
    the launch counts zeroed before and read after."""
    from ics_tpu_torch.ops import launch_counts, reset_launch_counts
    from ics_tpu_torch.tools import bench_vit_attn

    reset_launch_counts()
    result = bench_vit_attn.run(batch=32, iters=10)
    counts = launch_counts()
    for name, rec in result.items():
        log(f"  {name}: {rec['ms']:.4f} ms, max abs err against the exact plain version "
            f"{rec['max_abs_err']:.3e}")
    log(f"  launches: {counts}")
    if counts["flash_attention_bf16_exp"] < 1 or counts["flash_attention"] < 1:
        fail(f"tools.bench_vit_attn launched no kernel: {counts}")
    if result["bf16_exp"]["max_abs_err"] > BF16_TOL + BF16_EXP_TOL:
        fail(f"bf16_exp variant is {result['bf16_exp']['max_abs_err']} from the exact plain version")
    return counts["flash_attention_bf16_exp"]


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
                            steps["fused"], steps["unfused"], iters=10, ahead=False)
    log(f"    {32 / ms * 1e3:.0f} images/s with the chains, {32 / plain_ms * 1e3:.0f} without")
    del engines, steps, staged
    torch.cuda.empty_cache()


def check_new_models(torch) -> None:
    """Phase 5c: the four new families at full width. fp32 through the plain
    versions is the reference; bf16 through the kernels must deviate from it
    by at most twice what bf16 with cuDNN's grouped convolution (or the plain
    window attention) does, and agree with its top-1 at least as often. Then
    one bucket-32 engine step of each, kernels on and off, by CUDA events."""
    import numpy as np

    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.nn.layers import set_use_kernels
    from ics_tpu_torch.ops import launch_counts, reset_launch_counts
    from ics_tpu_torch.runtime.engine import InferenceEngine

    expected = {CONVNEXT: ("depthwise_conv", sum(CONVNEXT_DEPTHS)),
                SWIN: ("window_attention", sum(SWIN_DEPTHS)),
                MOBILENET: ("depthwise_conv", MOBILENET_LAUNCHES),
                EFFICIENTNET: ("depthwise_conv", None)}
    for name, (kernel, per_forward) in expected.items():
        spec = get_model(name)
        model = spec.build(num_classes=1000).init_weights(torch.Generator().manual_seed(0))
        # ConvNeXt's layer scale starts at 1e-6, which would hide its blocks,
        # and the depthwise kernel in them, from the logits
        for pname, param in model.named_parameters():
            if pname.endswith(".gamma"):
                param.data.fill_(0.5)
        model = model.fold().to("cuda").eval()
        g = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn((4, spec.image_size, spec.image_size, 3), generator=g, device="cuda")
        with torch.inference_mode():
            ref = set_use_kernels(model, False).apply_folded(x)
            fp32_kernel = set_use_kernels(model, True).apply_folded(x)
            model.to(torch.bfloat16)
            xb = x.to(torch.bfloat16)
            library = set_use_kernels(model, False).apply_folded(xb).float()
            reset_launch_counts()
            kernels = set_use_kernels(model, True).apply_folded(xb).float()
            launched = launch_counts()[kernel]
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        fp32_gap = (fp32_kernel - ref).abs().max().item()
        library_gap = (library - ref).abs().max().item()
        kernel_gap = (kernels - ref).abs().max().item()
        agree = {k: (v.argmax(-1) == ref.argmax(-1)).float().mean().item()
                 for k, v in (("kernels", kernels), ("library", library))}
        log(f"  {name} logits [4, 1000] (max|logit| {scale:.3e}): fp32 kernels vs fp32 plain "
            f"max|d|={fp32_gap:.3e} (tol 1e-3 of max|logit|); bf16 kernels {kernel_gap:.3e} vs "
            f"bf16 library {library_gap:.3e} from fp32 (tol 2x); top-1 agreement "
            f"{agree['kernels']:.2f} (library {agree['library']:.2f}); {launched} {kernel} "
            f"launches a forward")
        if not bool(torch.isfinite(kernels).all()):
            fail(f"{name}: non-finite logits from the kernel path")
        if fp32_gap > 1e-3 * max(scale, 1.0) or kernel_gap > 2 * library_gap \
                or agree["kernels"] < agree["library"]:
            fail(f"{name}: the full-width forward through the kernels disagrees with the "
                 "plain versions")
        if launched < 1 or (per_forward is not None and launched != per_forward):
            fail(f"{name}: {launched} {kernel} launches a forward, expected {per_forward}")
        del model
        torch.cuda.empty_cache()

        rng = np.random.default_rng(4)
        canvas = rng.integers(0, 256, (32, 512, 512, 3), np.uint8)
        sizes = rng.integers(300, 513, (32, 2)).astype(np.int32)
        on = InferenceEngine(name, precision="bf16", buckets=(32,), canvas=512)
        off = InferenceEngine(name, precision="bf16", buckets=(32,), canvas=512)
        set_use_kernels(off.model, False)
        staged = on._to_device(canvas, sizes)
        ms, plain_ms = in_turns(
            f"{name} bf16 engine step at bucket 32, kernels on (kernel) and off (library "
            "or plain version, under 'plain')",
            lambda: on._step(*staged), lambda: off._step(*staged), iters=10, ahead=False)
        log(f"    {32 / ms * 1e3:.0f} images/s with the kernels, {32 / plain_ms * 1e3:.0f} without")
        del on, off, staged
        torch.cuda.empty_cache()


# phase 5d: the device-decode lane's corpus, (h, w) as PIL gives them
DECODE_SIZES = ((224, 224), (375, 500), (750, 1000))
DECODE_MODES = ("420", "422", "444", "gray")
DECODE_CODINGS = {"baseline": {}, "progressive": {"progressive": True},
                  "restart": {"restart_marker_blocks": 4}}
# the documented device-vs-PIL decode error (docs/benchmarks.md), and the
# reference tests' bars: mean under 1, max at most 6 (gray 2)
DOC_MEAN_LSB, DOC_MAX_LSB = 0.4, 3


def decode_corpus() -> dict:
    """{(mode, coding, (h, w)): JPEG bytes}: seeded noise under the Gaussian
    blur of radius 2 that tests/test_jpeg_device_decode.py uses, quality 90."""
    import numpy as np
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(0)
    corpus = {}
    for h, w in DECODE_SIZES:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
            ImageFilter.GaussianBlur(2))
        for mode in DECODE_MODES:
            for coding, kw in DECODE_CODINGS.items():
                buf = io.BytesIO()
                if mode == "gray":
                    img.convert("L").save(buf, "JPEG", quality=90, **kw)
                else:
                    img.save(buf, "JPEG", quality=90,
                             subsampling={"444": 0, "422": 1, "420": 2}[mode], **kw)
                blob = buf.getvalue()
                if coding == "restart" and b"\xff\xdd" not in blob:
                    fail("PIL wrote no DRI segment for restart_marker_blocks")
                corpus[(mode, coding, (h, w))] = blob
    return corpus


def check_device_decode(torch) -> None:
    """Phase 5d: the device-decode lane on the card. The port's entropy
    decoder built and timed against PIL's full decode; per sampling mode the
    device-decoded canvas against PIL and the fp32 coefficient step against
    the fp32 pixel step fed that canvas's uint8; the bf16 coefficient and
    pixel steps at buckets 1, 8 and 32; the decode alone at bucket 32 beside
    its bound, with the kernels it launches (``tools.bench_decode.measure_decode``)."""
    import numpy as np
    from PIL import Image

    from ics_tpu_torch.native import imgcodec
    from ics_tpu_torch.runtime import device_decode as dd
    from ics_tpu_torch.runtime.decode import stage_batch
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.tools import bench_decode

    t0 = time.perf_counter()
    imgcodec.build_entropy()
    imgcodec.load_entropy()
    log(f"  entropy decoder (jpeg_entropy.cpp, g++ -O3) built in {time.perf_counter() - t0:.2f} s")
    corpus = decode_corpus()
    coeffs = {}
    for key, blob in corpus.items():
        co = imgcodec.jpeg_coefficients(blob)
        lane = dd.classify_coefficients(co)
        want_luma = 128 if key[2][1] > 512 else 64
        if co is None or lane != (key[0], want_luma):
            fail(f"device decode: {key} classified as {lane}, not ({key[0]!r}, {want_luma})")
        coeffs[key] = co
    log(f"  corpus: {len(corpus)} JPEGs ({', '.join(DECODE_MODES)} x "
        f"{', '.join(DECODE_CODINGS)} x {', '.join(f'{w}x{h}' for h, w in DECODE_SIZES)})")

    # host: the port's entropy decoder against PIL's full decode, by size
    for size in DECODE_SIZES:
        blobs = [b for k, b in corpus.items() if k[2] == size]
        runs = {"entropy": [], "pil": []}
        for name in ("entropy", "pil", "pil", "entropy"):
            t0 = time.perf_counter()
            for _ in range(3):
                for b in blobs:
                    if name == "entropy":
                        imgcodec.jpeg_coefficients(b)
                    else:
                        with Image.open(io.BytesIO(b)) as im:
                            im.convert("RGB").load()
            runs[name].append((time.perf_counter() - t0) / (3 * len(blobs)) * 1e6)
        ent, pil = (min(v) for v in (runs["entropy"], runs["pil"]))
        log(f"  host us/image at {size[1]}x{size[0]} (all modes and codings): entropy decode "
            f"{ent:.0f}, PIL full decode {pil:.0f} ({pil / ent:.2f}x)")

    # per mode: canvas against PIL, coefficient step against pixel step (fp32)
    fp32 = InferenceEngine(RESNET, precision="fp32", buckets=SERVER_BUCKETS, canvas=512, seed=0)
    for mode in DECODE_MODES:
        errs, n_pixels, worst = 0.0, 0, 0
        for luma in dd.LUMA_BUCKETS:
            keys = [k for k in corpus if k[0] == mode and (128 if k[2][1] > 512 else 64) == luma]
            staged = dd.stage_coefficient_batch([coeffs[k] for k in keys], luma, mode)
            dev = dd.to_device(staged, "cuda")
            with torch.inference_mode():
                canvas = dd.decode_batch_to_canvas(dev, mode=mode)
            u8 = canvas.to(torch.uint8).cpu().numpy()
            for i, key in enumerate(keys):
                h, w = key[2]
                with Image.open(io.BytesIO(corpus[key])) as im:
                    pil = np.asarray(im.convert("RGB")).astype(np.int64)
                e = np.abs(u8[i, :h, :w].astype(np.int64) - pil)
                errs += float(e.sum())
                n_pixels += e.size
                worst = max(worst, int(e.max()))
            ci, cs = fp32.predict_coeff_staged(dict(staged), mode=mode)
            pi, ps = fp32.predict_staged(u8, staged["sizes"])
            gap = float(np.abs(cs - ps).max())
            if (ci[:, 0] != pi[:, 0]).any() or gap > 1e-4:
                fail(f"device decode {mode}/{luma * 8}px: coefficient step top-1 {ci[:, 0]} vs "
                     f"pixel step {pi[:, 0]}, scores {gap:.3e} apart (tol 1e-4)")
            log(f"  {mode} {luma * 8}px lane, {len(keys)} images: fp32 coefficient step = pixel "
                f"step on the canvas's uint8 (top-1 equal, scores within {gap:.1e}, tol 1e-4)")
        mean = errs / n_pixels
        bar = 2 if mode == "gray" else 6
        log(f"  {mode} canvas vs PIL: mean {mean:.4f} LSB, max {worst} LSB (documented "
            f"{DOC_MEAN_LSB} / {DOC_MAX_LSB} LSB; bar mean < 1.0, max <= {bar})")
        if mean >= 1.0 or worst > bar:
            fail(f"device decode {mode}: canvas vs PIL mean {mean:.3f}, max {worst}")
    del fp32
    torch.cuda.empty_cache()

    # the bf16 steps as served, on the same 4:2:0 500x375 images
    eng = InferenceEngine(RESNET, precision="bf16", buckets=SERVER_BUCKETS, canvas=512,
                          fused_chains=True)
    blobs = [corpus[("420", c, (375, 500))] for c in DECODE_CODINGS]
    for bucket in SERVER_BUCKETS:
        picks = [blobs[i % len(blobs)] for i in range(bucket)]
        staged = dd.stage_coefficient_batch(
            [imgcodec.jpeg_coefficients(b) for b in picks], dd.LUMA_BLOCKS, "420")
        dev = dd.to_device(staged, "cuda")
        step = eng._get_coeff_step("420")
        images = []
        for b in picks:
            with Image.open(io.BytesIO(b)) as im:
                images.append(np.asarray(im.convert("RGB")))
        canvas, sizes = stage_batch(images, canvas=512)
        pix = eng._to_device(canvas, sizes)
        coeff_ms, pixel_ms = in_turns(
            f"{RESNET} bf16 fused-chains step at bucket {bucket}: coefficient step "
            "(under 'kernel') and pixel step (under 'plain')",
            lambda: step(*(dev[k] for k in dd.STAGED_KEYS)), lambda: eng._step(*pix),
            iters=10, ahead=False)
        coeff_bytes = sum(v.nbytes for v in staged.values())
        pixel_bytes = canvas.nbytes + sizes.nbytes
        log(f"    bytes to the device per batch: coefficient lane {coeff_bytes}, pixel lane "
            f"{pixel_bytes} ({pixel_bytes / coeff_bytes:.2f}x); decode share of the "
            f"coefficient step {(coeff_ms - pixel_ms) / coeff_ms * 100:.1f} %")
    del eng
    torch.cuda.empty_cache()

    # the decode alone at bucket 32, 4:2:0 512 px
    picks = [blobs[i % len(blobs)] for i in range(32)]
    staged = dd.stage_coefficient_batch(
        [imgcodec.jpeg_coefficients(b) for b in picks], dd.LUMA_BLOCKS, "420")
    dev = dd.to_device(staged, "cuda")

    r = bench_decode.measure_decode(dev, "420")
    if r["kernels"] is None:
        fail("device decode: torch.profiler saw no kernel of decode_batch_to_canvas")
    log(f"  decode_batch_to_canvas at bucket 32 (4:2:0, 512 px): {r['runs_ms']} ms, mean "
        f"{r['ms']:.4f} ms, host {r['host_ms']:.3f} ms to queue a call; bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} bytes at "
        f"{bench_decode.HBM_BYTES_S / 1e12:.2f} TB/s, {r['operations']} fp32 operations; "
        f"{r['ms'] / r['bound_ms']:.1f}x the bound); kernels launched per call: {r['kernels']}")
    del dev
    torch.cuda.empty_cache()


RESTART_SIZES = ((750, 1000), (1536, 2048))   # (h, w) of phase 5d's restart-marker JPEGs
DECODE_THREADS = (1, 2, 4, 8)


def restart_corpus() -> dict:
    """Seeded blurred noise at q90 with a restart marker every MCU row, in
    each sampling mode, at 1000x750 and 2048x1536: {(mode, (h, w)): bytes}."""
    import numpy as np
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(11)
    out = {}
    for h, w in RESTART_SIZES:
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        img = img.filter(ImageFilter.GaussianBlur(1.5))
        for mode in DECODE_MODES:
            buf = io.BytesIO()
            if mode == "gray":
                img.convert("L").save(buf, "JPEG", quality=90, restart_marker_rows=1)
            else:
                img.save(buf, "JPEG", quality=90, restart_marker_rows=1,
                         subsampling={"444": 0, "422": 1, "420": 2}[mode])
            out[mode, (h, w)] = buf.getvalue()
    return out


def _coeff_bytes(co) -> bytes:
    return b"".join(c["coeffs"].tobytes() + c["quant"].tobytes() for c in co.components)


def check_threaded_decode() -> None:
    """Phase 5d, restart segments on worker threads: every restart-marker
    JPEG of ``restart_corpus`` decoded on 1, 2, 4 and 8 threads gives the
    serial decode's bytes, and the threads ran on each file of at least
    ``MT_MIN_BYTES``; the host's us per image at each thread count beside
    PIL's full decode (the least of three rounds, in turns)."""
    from PIL import Image

    from ics_tpu_torch.native import imgcodec

    corpus = restart_corpus()
    for (mode, (h, w)), blob in corpus.items():
        serial = _coeff_bytes(imgcodec.jpeg_coefficients(blob, 1))
        for threads in DECODE_THREADS[1:]:
            before = imgcodec.threaded_scans()
            got = _coeff_bytes(imgcodec.jpeg_coefficients(blob, threads))
            ran = imgcodec.threaded_scans() - before
            if got != serial:
                fail(f"restart segments: {mode} {w}x{h} on {threads} threads differs from serial")
            if ran != (len(blob) >= imgcodec.MT_MIN_BYTES):
                fail(f"restart segments: {mode} {w}x{h} ({len(blob)} bytes) took the threads "
                     f"{ran} times on {threads} threads")
    for size in RESTART_SIZES:
        blobs = [b for k, b in corpus.items() if k[1] == size]
        runs: dict = {t: [] for t in (*DECODE_THREADS, "pil")}
        for _ in range(3):
            for t in (*DECODE_THREADS, "pil"):
                t0 = time.perf_counter()
                for b in blobs:
                    if t == "pil":
                        with Image.open(io.BytesIO(b)) as im:
                            im.convert("RGB").load()
                    else:
                        imgcodec.jpeg_coefficients(b, t)
                runs[t].append((time.perf_counter() - t0) / len(blobs) * 1e6)
        best = {t: min(v) for t, v in runs.items()}
        log(f"  restart segments at {size[1]}x{size[0]} ({', '.join(DECODE_MODES)}; "
            f"{min(len(b) for b in blobs)}-{max(len(b) for b in blobs)} bytes): entropy decode "
            + ", ".join(f"{t} thread{'s' * (t > 1)} {best[t]:.0f}" for t in DECODE_THREADS)
            + f" us/image; PIL full decode {best['pil']:.0f}; serial/8 threads "
            f"{best[1] / best[8]:.2f}x; bytes equal to serial on 2, 4, 8 threads in every mode")


# phase 5e: DenseNet and RegNet
DENSE_REGNET = ("densenet121", "densenet169", "regnet_y_400mf", "regnet_y_1_6gf")


def _dense_buffer_forward(model, x):
    """The folded DenseNet with each dense block written into one buffer at
    the block's final width (each layer's new channels copied into their
    slice) in place of the served concatenation per layer: the other form of
    the dense blocks, timed beside it in [5e]."""
    import torch

    from ics_tpu_torch.nn.layers import global_avg_pool, max_pool, relu

    y = max_pool(relu(model.stem.apply_folded(x)), 3, 2, 1)
    for i, layers in enumerate(model.stages):
        c = y.shape[-1]
        growth = layers[0].conv2.weight.shape[0]
        out = y.new_empty(*y.shape[:-1], c + growth * len(layers))
        out[..., :c] = y
        for layer in layers:
            bn = lambda m, t: m.apply_folded(t)   # noqa: E731
            h = layer.conv1(relu(bn(layer.bn1, out[..., :c])))
            out[..., c:c + growth] = layer.conv2(relu(bn(layer.bn2, h)))
            c += growth
        y = out
        if i < len(model.down):
            y = model.down[i].apply_folded(y)
    return model.head(global_avg_pool(torch.relu(model.final_bn.apply_folded(y))))


def kernels_a_step(torch, step) -> tuple[int, dict]:
    """The CUDA kernels one call of ``step`` launches, by ``torch.profiler``:
    (count, {group: (count, device ms)}) with ``tools.profile_step``'s groups."""
    from ics_tpu_torch.tools.profile_step import group_of

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    groups: dict = {}
    total = 0
    for ev in prof.key_averages():
        is_kernel = str(getattr(ev, "device_type", "")).endswith("CUDA")
        device_us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if not is_kernel or device_us <= 0:
            continue
        n, ms = groups.get(group_of(ev.key), (0, 0.0))
        groups[group_of(ev.key)] = (n + ev.count, round(ms + device_us / 1e3, 4))
        total += ev.count
    return total, groups


def check_dense_regnet(torch) -> None:
    """Phase 5e: DenseNet-121/169 and RegNet-Y 400MF/1.6GF at full width on
    the card, random weights from seed 0. The bf16 engine's logits against
    the fp32 engine's on eight seeded images: finite, the largest deviation
    printed, and the top-1 equal on every image whose fp32 margin between its
    first two classes is more than twice that deviation. Then bf16 engine
    steps at buckets 1, 8 and 32 by CUDA events, images/s at bucket 32, the
    kernels a bucket-32 step launches by ``torch.profiler`` (and where their
    device time goes), no kernel of the port among them; for DenseNet, the
    served forward (the reference's concatenation per layer) in turns with a
    buffer a dense block. Then the pretrained import on the card: the
    port's ``save_npz`` of a seeded ``regnet_y_400mf`` and ``densenet121``,
    loaded by ``load_pretrained`` into an fp32 engine, gives the seeded
    engine's logits exactly."""
    import numpy as np

    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.ops import launch_counts, reset_launch_counts
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.train.pretrained import load_pretrained, save_npz

    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (32, 512, 512, 3), np.uint8)
    sizes = rng.integers(300, 513, (32, 2)).astype(np.int32)

    def logits(engine, n):
        staged = engine._to_device(canvas[:n], sizes[:n])
        with torch.inference_mode():
            return engine.model.apply_folded(engine._preprocess(*staged, False)).float()

    for name in DENSE_REGNET:
        t0 = time.perf_counter()
        f32 = InferenceEngine(name, precision="fp32", buckets=(8,), canvas=512)
        b16 = InferenceEngine(name, precision="bf16", buckets=SERVER_BUCKETS, canvas=512)
        ref, got = logits(f32, 8), logits(b16, 8)
        top2 = ref.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1])
        dev = (got - ref).abs().max().item()
        agree = got.argmax(-1) == ref.argmax(-1)
        decided = margin > 2 * dev
        log(f"  {name}: bf16 vs fp32 logits [8, 1000] (max|logit| {ref.abs().max().item():.3e}): "
            f"max|d| {dev:.3e}; top-1 equal on {int(agree.sum())} of 8 (fp32 margins "
            f"{[round(v, 4) for v in margin.tolist()]}); built in {time.perf_counter() - t0:.1f} s")
        if not bool(torch.isfinite(got).all()) or not bool(agree[decided].all()):
            fail(f"{name}: bf16 top-1 differs from fp32 where the margin exceeds the deviation")
        del f32
        step_ms = {}
        for bucket in SERVER_BUCKETS:
            staged = b16._to_device(canvas[:bucket], sizes[:bucket])
            step = lambda: b16._step(*staged)   # noqa: E731
            cuda_ms(step, 3, ahead=False)
            step_ms[bucket] = min(cuda_ms(step, 10, ahead=False) for _ in range(2))
        reset_launch_counts()
        n_kernels, groups = kernels_a_step(torch, step)
        ours = {k: v for k, v in launch_counts().items() if v}
        log(f"    bf16 engine step by CUDA events: " + ", ".join(
            f"bucket {b} {ms:.3f} ms" for b, ms in step_ms.items())
            + f"; {32 / step_ms[32] * 1e3:.0f} images/s at bucket 32; {n_kernels} kernels a "
            f"bucket-32 step: {json.dumps(groups)}")
        if ours:
            fail(f"{name}: a step launched kernels of the port: {ours}")
        if name.startswith("densenet"):
            x = b16._preprocess(*staged, False)
            with torch.inference_mode():
                other = _dense_buffer_forward(b16.model, x).float()
                served = b16.model.apply_folded(x).float()
                if not torch.equal(other, served):
                    fail(f"{name}: the block-buffer forward differs from the served one")
                in_turns(f"{name} bf16 forward at bucket 32: torch.cat per layer (served, under "
                         "'kernel') and a buffer a dense block (under 'plain')",
                         lambda: b16.model.apply_folded(x),
                         lambda: _dense_buffer_forward(b16.model, x), iters=10, ahead=False)
                n_cat, cat_groups = kernels_a_step(torch, lambda: b16.model.apply_folded(x))
                n_buf, buf_groups = kernels_a_step(torch, lambda: _dense_buffer_forward(b16.model,
                                                                                        x))
            log(f"    kernels a forward: torch.cat per layer {n_cat} {json.dumps(cat_groups)}; "
                f"a buffer a dense block {n_buf} {json.dumps(buf_groups)}")
        del b16
        torch.cuda.empty_cache()

    for name in ("regnet_y_400mf", "densenet121"):
        model = get_model(name).build(num_classes=1000)
        model.init_weights(torch.Generator().manual_seed(0))
        with tempfile.TemporaryDirectory(prefix="ics_tpu_torch_pretrained_") as tmp:
            path = Path(tmp) / f"{name}.npz"
            save_npz(path, model.state_dict())
            n_bytes = path.stat().st_size
            _, state_dict = load_pretrained(name, path)
        seeded = InferenceEngine(name, precision="fp32", buckets=(8,), canvas=512, seed=0)
        loaded = InferenceEngine(name, precision="fp32", buckets=(8,), canvas=512,
                                 state_dict=state_dict)
        a, b = logits(seeded, 8), logits(loaded, 8)
        log(f"  pretrained {name}: save_npz -> load_pretrained -> fp32 engine on the card: "
            f"logits max|d| {(a - b).abs().max().item():.3e} from the seeded engine's "
            f"(a native file of {n_bytes} bytes)")
        if not torch.equal(a, b):
            fail(f"pretrained {name}: the loaded engine's logits differ from the seeded engine's")
        del seeded, loaded
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
    """Phase 6 over HTTP: six stretches, the launch counts zeroed before
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
            decodes = sorted({res["decode"] for batch in results + again for res in batch})
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
                "max_batch_seen": max([after["batcher"]["max_batch_seen"]] + [
                    lane["max_batch_seen"] for lane in after.get("coeff_lanes", {}).values()]),
                "decodes": decodes,
                "wall_s": wall_s,
            }

        # 6 images in one request (the batcher forms a batch of them) beside
        # 3 single-image requests; then the same to ViT-B/16, which the pool
        # builds on its first request; then 4 PNGs that are exactly 384x384;
        # then the same JPEGs to each new family
        mixed = [jpegs[:6], *([b] for b in jpegs[6:9])]
        drive = {
            "resnet_jpeg": await stretch("resnet_jpeg", RESNET, "", mixed),
            "vit_jpeg": await stretch("vit_jpeg", VIT, f"?modelo={VIT}", mixed),
            "vit_png": await stretch("vit_png", VIT, f"?modelo={VIT}", [pngs]),
        }
        for model in (CONVNEXT, SWIN, MOBILENET):
            drive[model] = await stretch(model, model, f"?modelo={model}", mixed)
        drive["decode_lanes"] = await decode_lanes(c, h, status)
        # DenseNet and RegNet through the pool, one PNG a request (the host
        # lane, a batch of 1), each answer kept for the in-process engine
        for model in SERVED_FAMILIES:
            before = await status(model)
            (await c.post("/inferencia/kernels/zerar", headers=h)).raise_for_status()
            answers = [(await classify([b], model, f"?modelo={model}", "png"))[0]
                       for b in family_pngs()]
            after = await status(model)
            drive[model] = {"model": model, "images": len(answers),
                            "batches": after["batches"] - before["batches"],
                            "launches": after["kernel_launches"], "backend": after["backend"],
                            "decodes": sorted({a["decode"] for a in answers}),
                            "answers": [(a["top_classes"], a["scores"]) for a in answers]}
        # a restart-marker JPEG of at least MT_MIN_BYTES on the default model:
        # its entropy decode takes TPU_DECODE_THREADS threads in the server
        blob = restart_corpus()["420", RESTART_SIZES[0]]
        before = await status(RESNET)
        answer = (await classify([blob], RESNET, ""))[0]
        after = await status(RESNET)
        drive["restart_jpeg"] = {
            "model": RESNET, "bytes": len(blob), "batches": after["batches"] - before["batches"],
            "backend": after["backend"], "decodes": [answer["decode"]],
            "threaded_scans": after["entropy_threaded_scans"] - before["entropy_threaded_scans"],
            "answer": (answer["top_classes"], answer["scores"])}
        return drive


async def decode_lanes(c, h, status) -> dict:
    """Phase 6's lane stretch on the default model: one JPEG of each sampling
    mode at each luma bucket (500x375 and 1000x750), a PNG and a JPEG over
    1024 px, in one request; then the lanes in /inferencia/status and the
    device-decode gauges of /monitor/metrics."""
    corpus = decode_corpus()
    keys = [(mode, "baseline", size) for mode in DECODE_MODES for size in DECODE_SIZES[1:]]
    blobs = [corpus[k] for k in keys] + _images([(384, 384)], "PNG") + \
        _images([(1100, 800)], "JPEG", quality=90)
    want = [f"device:{k[0]}" for k in keys] + ["host", "host"]
    before = await status(RESNET)
    (await c.post("/inferencia/kernels/zerar", headers=h)).raise_for_status()
    t0 = time.perf_counter()
    kinds = ["jpg"] * len(keys) + ["png", "jpg"]
    files = [("files", (f"img{i}.{kind}", b, f"image/{kind}"))
             for i, (b, kind) in enumerate(zip(blobs, kinds))]
    r = await c.post("/inferencia/classificar", files=files, headers=h)
    if r.status_code != 200:
        fail(f"decode lanes: /inferencia/classificar returned {r.status_code}: {r.text[:500]}")
    results = r.json()["resultados"]
    for res in results:
        _check_result(res, RESNET)
    wall_s = time.perf_counter() - t0
    got = [res["decode"] for res in results]
    if got != want:
        fail(f"decode lanes: answers say {got}, wanted {want}")
    after = await status(RESNET)
    text = (await c.get("/monitor/metrics")).text
    gauges = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            gauges[name] = float(value)
    lanes = {f"{mode}_{px}px" for mode in DECODE_MODES for px in (512, 1024)}
    return {
        "model": RESNET,
        "images": len(blobs),
        "batches": after["batches"] - before["batches"],
        "launches": after["kernel_launches"],
        "backend": after["backend"],
        "fused_chains": after["fused_chains"],
        "decodes": sorted(set(got)),
        "lane_flushes": {k: v["flushes"] for k, v in sorted(after["coeff_lanes"].items())},
        "missing_lanes": sorted(lanes - set(after["coeff_lanes"])),
        "device_decoded": after["device_decoded"],
        "metrics": {k: v for k, v in gauges.items()
                    if k == "tpu_device_decoded_total" or k.startswith("tpu_lane_flushes_")},
        "wall_s": wall_s,
    }


async def await_lane_warm_up(base: str, admin: tuple[str, str], t0: float) -> None:
    """Wait for the background warm-up of the other decode lanes, so that no
    warm-up step runs inside a stretch's launch counts."""
    import httpx

    async with httpx.AsyncClient(base_url=base, timeout=60) as c:
        r = await c.post("/auth/login", data={"username": admin[0], "password": admin[1]})
        r.raise_for_status()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}
        while True:
            st = (await c.get("/inferencia/status", headers=h)).json()
            if not st.get("decode_lanes_warming"):
                break
            if time.perf_counter() - t0 > SERVER_START_S:
                fail("the decode lanes' background warm-up did not end")
            await asyncio.sleep(0.5)
    log(f"  every decode lane warm {time.perf_counter() - t0:.1f} s after start "
        "(4:2:0/4:2:2/4:4:4/gray x 512/1024 px)")


@contextlib.contextmanager
def serving(tmp: str, **env_overrides):
    """One ``python -m ics_tpu_torch.main`` on a free port: ResNet-50 with
    fused chains in bf16, buckets 1/8/32, warmed at startup, TPU_DEVICE_DECODE
    at its default (on), its database a SQLite file in ``tmp``. Yields (base
    URL, admin credentials, database URL, seconds until /health answered);
    stops the process on the way out."""
    import httpx

    port = _free_port()
    admin = ("smoke-admin@example.com", "smoke-" + os.urandom(8).hex())
    database = f"sqlite:///{tmp}/smoke.db"
    env = dict(
        {k: v for k, v in os.environ.items() if k != "TPU_DEVICE_DECODE"},  # its default, on
        ENV="test",
        DATABASE_URL=database,
        JWT_SECRET_KEY=os.urandom(16).hex(),
        ADMIN_EMAIL=admin[0],
        ADMIN_SENHA=admin[1],
        NEXTCLOUD_BASE_URL="",
        TPU_ENABLE_INFERENCE="true",
        TPU_DEFAULT_MODEL=RESNET,
        TPU_FUSED_CHAINS="true",
        TPU_PRECISION="bf16",
        TPU_BATCH_BUCKETS=",".join(map(str, SERVER_BUCKETS)),
        TPU_WARMUP_ON_STARTUP="true",
    )
    env.update(env_overrides)
    server_log = Path(tmp) / "server.log"
    with open(server_log, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ics_tpu_torch.main", "--host", "127.0.0.1",
             "--port", str(port)],
            cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
        try:
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
            yield base, admin, database, time.perf_counter() - t0
        finally:
            _stop(proc)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


SERVED_FAMILIES = ("densenet121", "regnet_y_1_6gf")   # phase 6's ?modelo= stretches of 5e's
SERVED_DECODE_THREADS = 4                             # phase 6's TPU_DECODE_THREADS
SERVED_SCORE_TOL = 1e-3    # the server's bf16 scores against this process's engine


def family_pngs() -> list[bytes]:
    return _images([(300, 400), (512, 384), (256, 256), (480, 360)], "PNG")


def serve_and_drive() -> dict:
    with tempfile.TemporaryDirectory(prefix="ics_tpu_torch_smoke_") as tmp:
        with serving(tmp, TPU_DECODE_THREADS=str(SERVED_DECODE_THREADS)) as (
                base, admin, _, up_s):
            log(f"  server up in {up_s:.1f} s (engine built, pixel buckets and the 4:2:0 "
                "512 px decode lane warmed)")
            asyncio.run(await_lane_warm_up(base, admin, time.perf_counter() - up_s))
            return asyncio.run(drive_server(base, admin))


def check_drive(drive: dict) -> dict:
    """Phase 6's verdict: every stretch ran on the card, through the kernels
    of its path and no other. Returns the launches per kernel."""
    for name, st in drive.items():
        log(f"  {name}: {json.dumps(st)}")
        want = ["host"] if name in ("vit_png", *SERVED_FAMILIES) else None
        if name not in ("vit_png", "decode_lanes", *SERVED_FAMILIES) and \
                not all(d.startswith("device:") for d in st["decodes"]):
            fail(f"{name}: JPEGs answered {st['decodes']}; every one must take a device lane")
        if want and st["decodes"] != want:
            fail(f"{name}: PNGs answered {st['decodes']}, not the host lane")
        if name in SERVED_FAMILIES and any(st["launches"].values()):
            fail(f"{name}: {st['launches']}; no kernel of the port is on its path")
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
    lanes = drive["decode_lanes"]
    if lanes["missing_lanes"] or min(lanes["lane_flushes"].values()) < 1:
        fail(f"decode lanes: flushes {lanes['lane_flushes']}, missing {lanes['missing_lanes']}")
    if lanes["metrics"].get("tpu_device_decoded_total", 0) <= 0 or \
            len([k for k in lanes["metrics"] if k.startswith("tpu_lane_flushes_")]) < 9:
        fail(f"decode lanes: /monitor/metrics reads {lanes['metrics']}")
    if lanes["launches"]["bottleneck_chain"] < CHAIN_LAUNCHES * lanes["batches"]:
        fail(f"decode lanes: {lanes['launches']} for {lanes['batches']} batches; "
             f"bottleneck_chain must launch {CHAIN_LAUNCHES} times per batch")
    # the new families: exactly their own kernel, once per block per batch
    for model, kernel, per_batch in ((CONVNEXT, "depthwise_conv", sum(CONVNEXT_DEPTHS)),
                                     (SWIN, "window_attention", sum(SWIN_DEPTHS)),
                                     (MOBILENET, "depthwise_conv", MOBILENET_LAUNCHES)):
        st = drive[model]
        others = {k: v for k, v in st["launches"].items() if k != kernel and v}
        if st["launches"][kernel] != per_batch * st["batches"] or others:
            fail(f"{model}: {st['launches']} for {st['batches']} batches; the path must "
                 f"launch {kernel} {per_batch} times per batch and no other kernel")
    restart = drive["restart_jpeg"]
    if restart["bytes"] < MT_MIN_BYTES or restart["threaded_scans"] != 1 \
            or restart["decodes"] != ["device:420"]:
        fail(f"restart_jpeg: {restart}; a restart JPEG of {MT_MIN_BYTES} bytes or more must be "
             f"entropy-decoded on {SERVED_DECODE_THREADS} threads and take the 4:2:0 lane")
    return {
        "flash_attention": jpg["launches"]["flash_attention"] + png["launches"]["flash_attention"],
        "bottleneck_chain": res["launches"]["bottleneck_chain"]
        + lanes["launches"]["bottleneck_chain"],
        "normalize_u8": png["launches"]["normalize_u8"],
        # ConvNeXt-T's launches are the kernel at k 7, MobileNetV3-Small's at k 3 and 5
        "depthwise_conv": drive[CONVNEXT]["launches"]["depthwise_conv"],
        "depthwise_conv_k35": drive[MOBILENET]["launches"]["depthwise_conv"],
        "window_attention": drive[SWIN]["launches"]["window_attention"],
    }


def check_served_answers(torch, drive: dict) -> None:
    """Phase 6's answers against this process's engines, built as the server
    builds them (bf16, seed 0): the DenseNet and RegNet answers against
    ``predict_staged`` of the same PNGs (top-5 equal, scores within
    ``SERVED_SCORE_TOL``), and the restart JPEG's, decoded on threads in the
    server, against the serial decode's coefficient step (the same)."""
    import numpy as np

    from ics_tpu_torch.native import imgcodec
    from ics_tpu_torch.runtime import device_decode as dd
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch
    from ics_tpu_torch.runtime.engine import InferenceEngine

    def held(label, got, idx, scores):
        gap = float(np.abs(np.asarray(got[1]) - scores).max())
        log(f"  {label}: served top-5 {got[0]}, in-process {idx.tolist()}; scores max|d| "
            f"{gap:.2e} (tol {SERVED_SCORE_TOL})")
        if list(got[0]) != idx.tolist() or gap > SERVED_SCORE_TOL:
            fail(f"{label}: the served answer differs from this process's engine")

    for model in SERVED_FAMILIES:
        engine = InferenceEngine(model, precision="bf16", buckets=SERVER_BUCKETS, canvas=512)
        for i, (blob, got) in enumerate(zip(family_pngs(), drive[model]["answers"])):
            canvas, sizes = stage_batch([decode_image(blob)], canvas=None)
            idx, scores = engine.predict_staged(canvas, sizes)
            held(f"{model} PNG {i}", got, idx[0], scores[0])
        del engine
        torch.cuda.empty_cache()
    engine = InferenceEngine(RESNET, precision="bf16", buckets=SERVER_BUCKETS, canvas=512,
                             fused_chains=True)
    co = imgcodec.jpeg_coefficients(restart_corpus()["420", RESTART_SIZES[0]], 1)
    mode, luma = dd.classify_coefficients(co)
    idx, scores = engine.predict_coeff_staged(dd.stage_coefficient_batch([co], luma, mode),
                                              mode=mode)
    held(f"restart JPEG ({drive['restart_jpeg']['bytes']} bytes, {SERVED_DECODE_THREADS} "
         "threads in the server; serial here)", drive["restart_jpeg"]["answer"], idx[0], scores[0])
    del engine
    torch.cuda.empty_cache()


# phase 7: the ingestion front
INGEST_JPEGS = 96            # 64-512 px, each sampling mode, every third group progressive
INGEST_FOLDERS = ("campo", "laboratorio")
SYNC_READY_S = 300           # the sync of the corpus must be answered within this
# a suggestion against POST /inferencia/classificar on the same bytes: the two
# run bf16 in differently composed batches (other buckets, other padding), so
# each score may move by a few bf16 ulps of the largest probability (one ulp
# at 1.0 is 7.8e-3); top-1 must agree unless the top two lie within this
SUGGESTION_TOL = 2e-2
EMBED_NORM_TOL = 1e-2        # the stored vector is fp16 of a unit vector
# bf16 through the chain kernel against the fp32 plain path: 1 - cosine at
# most this (9.4e-6 measured on the H100), below that of the nearest other
# image's vector (7.4e-5: with random weights the corpus's vectors lie within
# 6e-4 of one another); each stored vector must also be nearest its own image's
EMBED_MAX_ANGLE = 3e-5
# a route's score against the fp32 sum of the same bf16 products in numpy
# (another summation order); hits whose fp32 scores lie closer than this may
# come in either order
SCORE_TOL = 1e-5
SIMILAR_CHECKED = 8
KNN_LABELLED = 12
EMBED_WIDTH = 2048           # ResNet-50's pooled features
DEVICE = "cuda"              # where phase 7's in-process references run


def ingestion_corpus() -> dict:
    """{(folder, name): bytes}: 96 JPEGs of 64-512 px (4:2:0, 4:2:2, 4:4:4 and
    gray in turn, every third group of four progressive; seeded noise under
    the Gaussian blur of [5d], quality 90), 4 PNGs and 2 JPEGs over 1024 px
    (both of those take the host lane)."""
    import numpy as np
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(9)

    def picture(h, w):
        return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
            ImageFilter.GaussianBlur(2))

    corpus = {}
    for i in range(INGEST_JPEGS):
        mode = DECODE_MODES[i % 4]
        progressive = (i // 4) % 3 == 2
        h, w = (int(v) for v in rng.integers(64, 513, 2))
        img, buf = picture(h, w), io.BytesIO()
        kw = {"progressive": True} if progressive else {}
        if mode == "gray":
            img.convert("L").save(buf, "JPEG", quality=90, **kw)
        else:
            img.save(buf, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[mode],
                     **kw)
        name = f"{i:03d}_{mode}{'_prog' if progressive else ''}.jpg"
        corpus[(INGEST_FOLDERS[i % 2], name)] = buf.getvalue()
    for i, (h, w) in enumerate([(200, 300), (384, 384), (90, 160), (512, 333)]):
        buf = io.BytesIO()
        picture(h, w).save(buf, "PNG")
        corpus[(INGEST_FOLDERS[i % 2], f"png_{i}.png")] = buf.getvalue()
    for i, (h, w) in enumerate([(800, 1100), (1040, 1300)]):
        buf = io.BytesIO()
        picture(h, w).save(buf, "JPEG", quality=90)
        corpus[(INGEST_FOLDERS[i % 2], f"big_{i}.jpg")] = buf.getvalue()
    return corpus


def _flushes(st: dict) -> int:
    return st["batcher"]["flushes"] + sum(lane["flushes"] for lane in st["coeff_lanes"].values())


def _db_rows(db) -> tuple[dict, dict]:
    """({hash: [resnet50 suggestion rows]}, {hash: stored embedding as fp32})
    read through the port's own database layer."""
    from ics_tpu_torch.crud.embedding_crud import carregar_corpus
    from ics_tpu_torch.db import models

    with db.session() as s:
        rows = {}
        for r in s.query(models.SugestaoModelo).filter(models.SugestaoModelo.modelo == RESNET).all():
            rows.setdefault(r.id_img, []).append(r)
        hashes, mat = carregar_corpus(s, RESNET)
    return rows, dict(zip(hashes, mat.astype("float32")))


def _setup_ambiente(db, hashes: list, options=("A", "B")) -> dict:
    """An ambiente over the synced conjuntos with ``options``, a specialist,
    and ``KNN_LABELLED`` of ``hashes`` labelled (the first two options in
    turn)."""
    from ics_tpu_torch.core import timezone as tz
    from ics_tpu_torch.core.security import hash_password
    from ics_tpu_torch.db import models as m

    now = tz.utcnow()
    password = "Smoke-" + os.urandom(6).hex()
    with db.session() as s:
        esp = m.Usuario(nome_completo="Especialista Smoke", email="esp-smoke@example.com",
                        senha_hash=hash_password(password), data_criado=now, id_tipo=1)
        s.add(esp)
        s.flush()
        con = m.UsuarioConvencional(cpf="7" * 11, id_usu=esp.id_usu)
        s.add(con)
        s.flush()
        adm = s.fetchone("SELECT id_adm FROM usuarios_administradores LIMIT 1")
        amb = m.Ambiente(titulo_amb="Smoke kNN", descricao_questionario="ingestion front",
                         data_criado=now, id_adm=adm["id_adm"])
        s.add(amb)
        s.flush()
        for cnj in s.query(m.ConjuntoImagens).all():
            s.add(m.AmbienteConjuntoImagens(id_amb=amb.id_amb, id_cnj=cnj.id_cnj,
                                            data_associado=now))
        s.add(m.UsuarioAmbiente(id_con=con.id_con, id_amb=amb.id_amb, data_associado=now))
        options = [m.Opcao(texto=t, id_amb=amb.id_amb) for t in options]
        s.add_all(options)
        s.flush()
        for i, h in enumerate(hashes[:KNN_LABELLED]):
            s.add(m.Classificacao(id_con=con.id_con, id_img=h, id_opc=options[i % 2].id_opc,
                                  data_criado=now, ativo=True))
        s.commit()
        return {"id_amb": str(amb.id_amb), "email": esp.email, "password": password,
                "options": [str(o.id_opc) for o in options]}


def _knn_row(db, content_hash: str):
    from ics_tpu_torch.db import models as m

    with db.session() as s:
        return [(r.modelo, str(r.id_amb)) for r in s.query(m.SugestaoModelo).filter(
            m.SugestaoModelo.id_img == content_hash).all() if r.modelo.startswith("knn:")]


def embeddings(torch, blobs, **engine_kwargs) -> list:
    """The embedding of each of ``blobs`` as ``embed_bytes`` computes it (host
    decode, a staged batch of 1), in this process on the card, on the
    server's weights (seed 0): the fp32 plain path (no kernel, TF32 off) by
    default, or the served path with ``precision="bf16", fused_chains=True``."""
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch
    from ics_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(RESNET, **{"precision": "fp32", **engine_kwargs}, buckets=(1,),
                             canvas=512, device=DEVICE)
    out = [engine.embed_staged(*stage_batch([decode_image(b)], canvas=None))[0] for b in blobs]
    del engine
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


async def drive_ingestion(base: str, admin: tuple, database: str, gate: Path,
                          corpus: dict) -> dict:
    """Phase 7 over HTTP: open the fake NextCloud's gate with the launch
    counts at 0 and wait until every synced image has its suggestion and its
    embedding; read the counts; then the routes of checks 2 and 5-8."""
    import httpx

    from ics_tpu_torch.core.security import sha256_hex
    from ics_tpu_torch.db.engine import Database

    db = Database(database)
    by_hash = {sha256_hex(blob): (folder, name, blob) for (folder, name), blob in corpus.items()}
    n = len(by_hash)
    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        r = await c.post("/auth/login", data={"username": admin[0], "password": admin[1]})
        r.raise_for_status()
        c.cookies.clear()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}
        before = (await c.get("/inferencia/status", headers=h)).json()
        sync0 = (await c.get("/monitor/status", headers=h)).json()["sync"]
        if sync0.get("last_sync_status") is not None or before["batches"] != 0:
            fail(f"ingestion: the sync ran before the gate opened: {sync0}, "
                 f"{before['batches']} batches")
        (await c.post("/inferencia/kernels/zerar", headers=h)).raise_for_status()
        t0 = time.perf_counter()
        gate.touch()
        while True:
            rows, vectors = _db_rows(db)
            if len(rows) == n and len(vectors) == n:
                break
            if time.perf_counter() - t0 > SYNC_READY_S:
                fail(f"ingestion: {len(rows)} suggestions and {len(vectors)} embeddings of "
                     f"{n} images after {SYNC_READY_S} s")
            await asyncio.sleep(0.1)
        ready_s = time.perf_counter() - t0
        after = (await c.get("/inferencia/status", headers=h)).json()
        drive = {
            "ready_s": ready_s, "images": n,
            "launches": after["kernel_launches"], "backend": after["backend"],
            "fused_chains": after["fused_chains"],
            "flushes": _flushes(after) - _flushes(before),
            "batches": after["batches"] - before["batches"],
            "device_decoded": after["device_decoded"] - before["device_decoded"],
            "host_decoded": after["host_decoded"] - before["host_decoded"],
            "device_errors": after["device_errors"] - before["device_errors"],
            "rows": rows, "vectors": vectors, "by_hash": by_hash,
        }

        # check 2: the same bytes through POST /inferencia/classificar
        answers = {}
        hashes = sorted(by_hash)
        for i in range(0, n, 16):
            chunk = hashes[i:i + 16]
            files = [("files", (by_hash[k][1], by_hash[k][2],
                                "image/png" if by_hash[k][1].endswith(".png") else "image/jpeg"))
                     for k in chunk]
            r = await c.post("/inferencia/classificar", files=files, headers=h)
            if r.status_code != 200:
                fail(f"ingestion: /inferencia/classificar returned {r.status_code}: {r.text[:300]}")
            answers.update(zip(chunk, r.json()["resultados"]))
        drive["answers"] = answers

        # check 5: neighbours by hash
        similar = {}
        for k in hashes[:: n // SIMILAR_CHECKED][:SIMILAR_CHECKED]:
            r = await c.get(f"/images/{k}/similares?limite=10")
            if r.status_code != 200:
                fail(f"ingestion: /images/{k[:12]}/similares returned {r.status_code}")
            similar[k] = [(x["content_hash"], x["score"]) for x in r.json()["similares"]]
        drive["similar"] = similar

        # check 6: a q75 re-encode of a synced image
        from PIL import Image

        original = next(k for k in hashes if by_hash[k][1].endswith("_420.jpg"))
        buf = io.BytesIO()
        Image.open(io.BytesIO(by_hash[original][2])).convert("RGB").save(buf, "JPEG", quality=75)
        r = await c.post("/images/buscar-similares?limite=50",
                         files={"file": ("q75.jpg", buf.getvalue(), "image/jpeg")})
        if r.status_code != 200:
            fail(f"ingestion: /images/buscar-similares returned {r.status_code}: {r.text[:300]}")
        drive["near_duplicate"] = (original, buf.getvalue(),
                                   [(x["content_hash"], x["score"]) for x in r.json()["similares"]])

        # check 7: a kNN vote in an ambiente over the synced conjuntos
        amb = _setup_ambiente(db, hashes)
        query = hashes[KNN_LABELLED]
        r = await c.post("/auth/login", data={"username": amb["email"],
                                              "password": amb["password"]})
        r.raise_for_status()
        c.cookies.clear()
        esp = {"Authorization": f"Bearer {r.json()['access_token']}"}
        r = await c.get(f"/classificacoes/ambiente/{amb['id_amb']}/sugerir-vizinhos/{query}",
                        headers=esp)
        if r.status_code != 200:
            fail(f"ingestion: sugerir-vizinhos returned {r.status_code}: {r.text[:300]}")
        drive["knn"] = (r.json(), _knn_row(db, query), amb["id_amb"])

        # check 8: /monitor/status, admin only
        drive["monitor"] = (await c.get("/monitor/status", headers=h)).json()
        drive["monitor_anonymous"] = (await c.get("/monitor/status")).status_code
    return drive


def _bf16(x):
    """``x`` rounded to bf16 (to nearest, ties to even), as fp32."""
    import numpy as np

    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _hold_to_scores(route: str, got: list, scores: dict, exclude=None) -> tuple:
    """Fail unless ``got`` ([(hash, score)], best first) is the top of
    ``scores`` ({hash: fp32 score}, ``exclude`` left out): each hit's score
    within SCORE_TOL of its own, and each rank held by a hash whose score lies
    within SCORE_TOL of that rank's. Returns (largest score gap, neighbouring
    ranks of ``scores`` closer than SCORE_TOL)."""
    ranked = sorted((sc for h, sc in scores.items() if h != exclude), reverse=True)
    if len({h for h, _ in got}) != len(got):
        fail(f"ingestion: {route} repeats a hit")
    for j, (h, sc) in enumerate(got):
        if h == exclude or h not in scores or abs(sc - scores[h]) > SCORE_TOL \
                or abs(scores[h] - ranked[j]) > SCORE_TOL:
            fail(f"ingestion: {route} rank {j}: {h[:12]} at {sc:.7f} (fp32 "
                 f"{scores.get(h, float('nan')):.7f}); the fp32 sums rank {ranked[j]:.7f} there")
    gap = max(abs(sc - scores[h]) for h, sc in got)
    return gap, sum(ranked[j] - ranked[j + 1] <= SCORE_TOL for j in range(len(got) - 1))


def check_ingestion(torch) -> int:
    """Phase 7: the ingestion front. Returns the chain launches of the sync
    stretch."""
    import numpy as np

    corpus = ingestion_corpus()
    with tempfile.TemporaryDirectory(prefix="ics_tpu_torch_ingest_") as tmp:
        root, gate = Path(tmp) / "nextcloud", Path(tmp) / "gate"
        for (folder, name), blob in corpus.items():
            (root / folder).mkdir(parents=True, exist_ok=True)
            (root / folder / name).write_bytes(blob)
        nc_port = _free_port()
        with open(Path(tmp) / "fake_nextcloud.log", "w") as nc_log:
            fake = subprocess.Popen(
                [sys.executable, "-m", "ics_tpu_torch.tools.fake_nextcloud", "--root", str(root),
                 "--port", str(nc_port), "--gate", str(gate)],
                cwd=ROOT, stdout=nc_log, stderr=subprocess.STDOUT)
            try:
                t0 = time.perf_counter()
                while True:
                    with socket.socket() as sock:
                        if sock.connect_ex(("127.0.0.1", nc_port)) == 0:
                            break
                    if fake.poll() is not None or time.perf_counter() - t0 > 60:
                        fail("the fake NextCloud did not start:\n"
                             + (Path(tmp) / "fake_nextcloud.log").read_text()[-2000:])
                    time.sleep(0.2)
                env = dict(
                    NEXTCLOUD_BASE_URL=f"http://127.0.0.1:{nc_port}",
                    NEXTCLOUD_USERNAME="tester", NEXTCLOUD_PASSWORD="smoke",
                    NEXTCLOUD_USER_PATH="/files/tester", NEXTCLOUD_VERIFY_SSL="false",
                    NEXTCLOUD_SYNC_INITIAL_ON_STARTUP="true",
                    TPU_CLASSIFY_ON_SYNC="true", TPU_EMBED_ON_SYNC="true",
                )
                with serving(tmp, **env) as (base, admin, database, up_s):
                    log(f"  server up in {up_s:.1f} s; the initial sync waits at the fake "
                        "NextCloud's gate")
                    asyncio.run(await_lane_warm_up(base, admin, time.perf_counter() - up_s))
                    drive = asyncio.run(drive_ingestion(base, admin, database, gate, corpus))
                    server_log = (Path(tmp) / "server.log").read_text()
            finally:
                _stop(fake)
    n, rows, vectors = drive["images"], drive["rows"], drive["vectors"]
    original, q75, found = drive["near_duplicate"]
    hashes = sorted(vectors)
    *fp32, fp32_q75 = embeddings(torch, [drive["by_hash"][k][2] for k in hashes] + [q75])
    fp32 = dict(zip(hashes, fp32))
    served_q75 = embeddings(torch, [q75], precision="bf16", fused_chains=True)[0]
    log(f"  card: {card_line()}")
    log(f"  sync of {n} images ({INGEST_JPEGS} JPEGs 64-512 px, 4 PNGs, 2 JPEGs over 1024 px, "
        f"two folders) to every suggestion and embedding stored: {drive['ready_s']:.3f} s, "
        f"{n / drive['ready_s']:.1f} images/s")
    log(f"  lanes: device-decoded {drive['device_decoded']}, host-decoded {drive['host_decoded']}; "
        f"classify flushes {drive['flushes']}, engine steps {drive['batches']}, "
        f"launches {drive['launches']}")
    if drive["backend"] != "cuda" or not drive["fused_chains"]:
        fail(f"ingestion: the engine reports backend {drive['backend']!r}, fused_chains "
             f"{drive['fused_chains']}")
    if "classify-on-sync failed" in server_log:
        fail("ingestion: the server logged a classify-on-sync failure")
    # 1. one resnet50 suggestion and one 2048-wide embedding per image
    if set(rows) != set(drive["by_hash"]) or any(len(v) != 1 for v in rows.values()):
        fail(f"ingestion: suggestions per image {sorted(len(v) for v in rows.values())}")
    if set(vectors) != set(drive["by_hash"]) or {v.shape for v in vectors.values()} != {(EMBED_WIDTH,)}:
        fail(f"ingestion: embeddings {len(vectors)}, widths {({v.shape for v in vectors.values()})}")
    if (drive["device_decoded"], drive["host_decoded"]) != (INGEST_JPEGS, n - INGEST_JPEGS):
        fail(f"ingestion: {drive['device_decoded']} device-decoded, {drive['host_decoded']} "
             f"host-decoded; wanted {INGEST_JPEGS} and {n - INGEST_JPEGS}")
    # 2. each suggestion is what /inferencia/classificar answers for the same bytes
    gap, flips = 0.0, 0
    for k, answer in drive["answers"].items():
        stored = rows[k][0].classes
        got = [c["score"] for c in stored]
        gap = max(gap, max(abs(a - b) for a, b in zip(got, answer["scores"])))
        if stored[0]["classe"] != answer["top_classes"][0]:
            if min(got[0] - got[1], answer["scores"][0] - answer["scores"][1]) > SUGGESTION_TOL:
                fail(f"ingestion: {drive['by_hash'][k][1]}: suggestion top-1 "
                     f"{stored[0]['classe']}, classify {answer['top_classes'][0]}")
            flips += 1
    log(f"  [2] suggestion vs /inferencia/classificar on the same bytes: largest score gap "
        f"{gap:.3e} (tolerance {SUGGESTION_TOL}); top-1 equal for {n - flips} of {n} "
        f"({flips} with the top two within the tolerance)")
    if gap > SUGGESTION_TOL:
        fail(f"ingestion: a suggestion's scores differ from the classify answer by {gap:.3e}")
    # 3. stored embeddings: unit norm; the fp32 plain path's vector of the same
    # image within EMBED_MAX_ANGLE, and nearer than that of any other image
    mat = np.stack([vectors[k] for k in hashes])
    plain = np.stack([fp32[k] for k in hashes])
    norms = np.linalg.norm(mat, axis=1)
    cos = (mat / norms[:, None]) @ plain.T
    own = 1.0 - np.diag(cos)
    other = 1.0 - np.max(np.where(np.eye(n, dtype=bool), -np.inf, cos), axis=1)
    nearest = np.argmax(cos, axis=1)
    log(f"  [3] stored embeddings: norms {norms.min():.5f}-{norms.max():.5f}; 1 - cosine with "
        f"the fp32 plain path on the card: largest {own.max():.3e} (bar {EMBED_MAX_ANGLE}); "
        f"with the nearest other image's: smallest {other.min():.3e}; nearest its own "
        f"image for {int((nearest == np.arange(n)).sum())} of {n}")
    if np.abs(norms - 1.0).max() > EMBED_NORM_TOL or own.max() > EMBED_MAX_ANGLE \
            or (nearest != np.arange(n)).any():
        fail("ingestion: a stored embedding is off its norm, off the fp32 plain path's vector "
             "of its image, or nearer another image's")
    # 4. the chain kernel, 5 launches in every classify flush and embed step
    launches = drive["launches"]["bottleneck_chain"]
    others = {k: v for k, v in drive["launches"].items() if k != "bottleneck_chain" and v}
    steps = drive["flushes"] + n
    log(f"  [4] bottleneck_chain launches over the sync: {launches} = {CHAIN_LAUNCHES} x "
        f"({drive['flushes']} classify flushes + {n} embed steps)?")
    if launches == 0 or launches != CHAIN_LAUNCHES * steps or drive["batches"] != steps \
            or others or drive["device_errors"]:
        fail(f"ingestion: launches {drive['launches']}, {drive['batches']} engine steps, "
             f"{drive['device_errors']} device errors for {steps} flushes and embed steps")
    # 5. neighbours by hash: the fp32 sums over the stored vectors as the index holds them
    matrix = _bf16(mat).astype(np.float64)

    def fp32_scores(query):
        return dict(zip(hashes, matrix @ _bf16(query).astype(np.float64)))

    gaps, ties = [], 0
    for k, got in drive["similar"].items():
        if len(got) != 10:
            fail(f"ingestion: /similares gave {len(got)} neighbours, not 10")
        gap, tie = _hold_to_scores(f"/images/{k[:12]}/similares", got, fp32_scores(vectors[k]), k)
        gaps.append(gap)
        ties += tie
    log(f"  [5] /images/{{hash}}/similares for {len(drive['similar'])} images: the order of the "
        f"fp32 sums in numpy, scores within {SCORE_TOL} (largest gap {max(gaps):.2e}); "
        f"neighbouring ranks closer than that: {ties} of {9 * len(gaps)}")
    # 6. a q75 re-encode: the route against numpy's fp32 sums for the served
    # query (this process, bf16 through the chain kernel); the original first
    # in the fp32 plain path
    name = drive["by_hash"][original][1]
    if len(found) != 50:
        fail(f"ingestion: /images/buscar-similares gave {len(found)} hits, not 50")
    scores = fp32_scores(served_q75)
    gap, tie = _hold_to_scores("/images/buscar-similares", found, scores)
    by_fp32 = sorted(hashes, key=lambda k: -float(fp32[k] @ fp32_q75))
    margin = float(fp32[by_fp32[0]] @ fp32_q75 - fp32[by_fp32[1]] @ fp32_q75)
    by_index = [h for h, _ in found]
    rank = by_index.index(original) if original in by_index else None
    log(f"  [6] q75 re-encode of {name}: the route against numpy's fp32 sums for the served "
        f"query: scores within {SCORE_TOL} (largest gap {gap:.2e}), {tie} of 49 neighbouring "
        f"ranks closer; the original's rank (0 = first): in the route (the bf16 index) "
        f"{rank}, fp32 sum {scores[original]:.6f} against the first's {found[0][1]:.6f}; in "
        f"the fp32 plain path "
        f"{by_fp32.index(original)} (margin {margin:.3e} over the runner-up); stored vectors' "
        f"smallest pairwise cosine {float(np.min(mat @ mat.T)):.5f}")
    if by_fp32[0] != original:
        fail(f"ingestion: the fp32 plain path ranks {drive['by_hash'][by_fp32[0]][1]} nearest "
             f"to the q75 re-encode of {name}")
    # 7. the kNN vote, stored as a knn:resnet50 suggestion
    vote, stored, id_amb = drive["knn"]
    total = sum(o["score"] for o in vote["opcoes"])
    log(f"  [7] sugerir-vizinhos: {vote['vizinhos']} neighbours, "
        f"{[(o['texto_opcao'], o['score']) for o in vote['opcoes']]}, sum {total:.6f}")
    if vote["modelo"] != f"knn:{RESNET}" or not vote["opcoes"] or abs(total - 1.0) > 1e-4 \
            or stored != [(f"knn:{RESNET}", id_amb)]:
        fail(f"ingestion: the kNN vote {vote}, stored {stored}")
    # 8. /monitor/status shows the sync
    sync = drive["monitor"]["sync"]
    log(f"  [8] /monitor/status sync: " + json.dumps(
        {k: sync.get(k) for k in ("enabled", "tasks", "activity_runs", "webdav_runs",
                                  "health_runs", "last_sync_status", "last_sync_method",
                                  "activity_api_failures", "webdav_failures")}))
    if not sync.get("enabled") or sync.get("last_sync_status") != "success" \
            or sync.get("last_sync_method") != "initial" or drive["monitor_anonymous"] != 401 \
            or drive["monitor"]["tpu"].get("backend") != "cuda":
        fail(f"ingestion: /monitor/status {drive['monitor']['sync']}, anonymous "
             f"{drive['monitor_anonymous']}")
    return launches



# phase 8: the serving extras
BWD_FP32_TOL = 1e-4   # largest |error| over max|ref|: fp32 sums in another order
BWD_BF16_TOL = 2e-2   # the plain version rounds dP, dq and dk to bf16 where the kernel does not
EXPLAIN_FP32_TOL = 1e-3
EXPLAIN_BF16_COSINE = 0.99
SMOOTH = 16           # the SmoothGrad batch the backward passes are timed at
TTA_TOL = 1e-3
TRAINED_TOL = 1e-3
TEMPERATURE = 2.0


def _rel_err(torch, got, ref) -> tuple:
    top = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(top, 1e-30), top


def check_backward(torch, window_attention, depthwise) -> dict:
    """Phase 8a: both backward passes against autograd of their plain
    versions, each case twice (bit for bit the same), each held to its bar
    relative to the largest gradient; returns the largest absolute error of
    each. The window backward at every Swin-T call at batch 1 and
    ``SMOOTH``, bf16 and fp32, the qkv product a view with NaN behind the
    batch; the depthwise input gradient, through autograd of the served
    module (``_DepthwiseConv``'s backward on the module's flipped taps), at
    every depthwise call of ConvNeXt-T, EfficientNet-B4 and MobileNetV3-Small
    at batch ``SMOOTH``, bf16 and fp32, with NaN around dy."""
    from ics_tpu_torch.tools.bench_depthwise import depthwise_calls
    from ics_tpu_torch.tools.bench_window import swin_calls

    worst = {"window_attention_qkv_bwd": 0.0, "depthwise_conv_dx": 0.0}

    def judge(name, label, runs, ref, dtype):
        rel, top = _rel_err(torch, runs[0], ref)
        same = torch.equal(runs[0], runs[1])
        tol = BWD_BF16_TOL if dtype == torch.bfloat16 else BWD_FP32_TOL
        log(f"  {label}: max|err|/max|ref| = {rel:.3e} (tol {tol:g}), max|ref| {top:.3e}, "
            f"twice the same {same}")
        if not bool(torch.isfinite(runs[0]).all()) or not (rel <= tol) or not same:
            fail(f"{label} disagrees with autograd of its plain version: {rel}, same {same}")
        worst[name] = max(worst[name], rel * top)

    for batch in (1, SMOOTH):
        for dtype in (torch.bfloat16, torch.float32):
            for grid, heads, shift, _, window, hd in swin_calls("swin_tiny"):
                qkv, table, index, mask = qkv_inputs(torch, batch, grid, heads, hd, window, shift,
                                                     dtype)
                g = torch.Generator().manual_seed(7)
                dout = torch.randn((batch, grid, grid, heads * hd), generator=g).to(dtype).cuda()
                args = (qkv, dout, table, index, mask, window, shift, hd ** -0.5)
                runs = [window_attention.window_attention_qkv_bwd(*args) for _ in range(2)]
                torch.cuda.synchronize()
                judge("window_attention_qkv_bwd",
                      f"window_attention_qkv_bwd {list(qkv.shape)} shift={shift} "
                      f"{str(dtype)[6:]}", runs,
                      window_attention.window_attention_qkv_bwd_reference(*args), dtype)
    for model in (CONVNEXT, EFFICIENTNET, MOBILENET):
        for shape, k, _ in sorted(depthwise_calls(model, SMOOTH)):
            for dtype in (torch.bfloat16, torch.float32):
                _, w, _ = depthwise_inputs(torch, shape, k, False, dtype)
                store = torch.full((shape[0] + 2, *shape[1:]), float("nan"), dtype=dtype,
                                   device="cuda")
                g = torch.Generator().manual_seed(3)
                store[1:-1] = torch.randn(shape, generator=g).to(dtype).cuda()
                dy = store[1:-1]
                runs = [_input_grad(torch, _depthwise_module(torch, w), dy) for _ in range(2)]
                torch.cuda.synchronize()
                judge("depthwise_conv_dx",
                      f"depthwise_conv_dx {list(shape)} k={k} {str(dtype)[6:]} ({model})", runs,
                      depthwise.depthwise_dx_reference(dy, w), dtype)
    return worst


def _depthwise_module(torch, w):
    """The module that serves a depthwise call, as ``fold()`` stores it
    (``Conv2D`` on the card in w's dtype, channels_last, its parameters
    without grad, its taps and flipped taps kept beside its weight), with
    the taps w [k, k, C]."""
    from ics_tpu_torch.nn.layers import Conv2D

    k, _, c = w.shape
    conv = Conv2D(c, c, k, 1, padding=k // 2, groups=c, use_bias=False)
    with torch.no_grad():
        conv.weight.copy_(w.float().permute(2, 0, 1).reshape(c, 1, k, k).cpu())
    return conv.to(device="cuda", dtype=w.dtype,
                   memory_format=torch.channels_last).requires_grad_(False)


def _input_grad(torch, forward, dy):
    """The gradient of ``forward`` with respect to its input at dy, through
    autograd (a convolution is linear in its input, so x = 0 will do)."""
    x = torch.zeros_like(dy, requires_grad=True)
    (dx,) = torch.autograd.grad(forward(x), x, dy)
    return dx


def _graphed_grad(torch, forward, inputs: tuple, dout):
    """The gradient of ``forward(*inputs)`` at ``dout`` with respect to
    ``inputs`` through autograd, captured once in a CUDA graph; returns its
    replay. A replay is what the card does for the backward alone: called
    through autograd, the host takes longer than the card at most of phase
    [8a]'s calls, and the time would be the host's."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        # the forward on the capture stream, where autograd then runs its backward
        out = forward(*inputs)
        for _ in range(3):     # a capture wants its work run once before
            torch.autograd.grad(out, inputs, dout, retain_graph=True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.autograd.grad(out, inputs, dout, retain_graph=True)
    return graph.replay


def _sdpa_backward(torch, call):
    """The yardstick of the window backward: the autograd backward of
    ``F.scaled_dot_product_attention`` with bias and mask as ``attn_mask`` on
    the partitioned q, k, v (the glue left out), as a CUDA graph's replay."""
    import torch.nn.functional as F

    from ics_tpu_torch.tools import bench_window

    qkv = tuple(call[n].detach().requires_grad_() for n in ("q", "k", "v"))
    attn_mask = bench_window.sdpa_mask(call)
    return _graphed_grad(
        torch, lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                             scale=1.0),
        qkv, torch.randn_like(qkv[0]))


def time_backward(torch, window_attention, depthwise) -> dict:
    """Phase 8a: CUDA-event times of both backward passes at the calls of one
    explain step at a SmoothGrad batch of ``SMOOTH`` (Swin-T's 12 window
    attentions, ConvNeXt-T's 18 depthwise convolutions), bf16, in turns with
    autograd of their plain versions, beside their bound and their library
    yardsticks (the autograd backward of SDPA with ``attn_mask`` on the
    partitioned q, k, v, replayed from a CUDA graph; ``torch.nn.grad.
    conv2d_input`` with ``groups=C`` on channels_last). The depthwise input
    gradient is timed as the served module's backward and its plain version
    as the backward of ``depthwise_reference``, both replayed from CUDA
    graphs of autograd (``_graphed_grad``).
    The window backward's bound: qkv and dO read, dqkv written, the table,
    index and mask read, or its 12 ww^2 hd operations a (window, head) at
    the bf16 peak; the depthwise input gradient's: dy and the taps read and
    dx written, or 2 k^2 operations an output at the bf16 peak (bf16
    operands)."""
    from ics_tpu_torch.tools import bench_window
    from ics_tpu_torch.tools.bench_window import swin_calls

    out = {}
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by = set()
    for grid, heads, shift, count, window, hd in swin_calls("swin_tiny"):
        call = bench_window.make_call(SMOOTH, grid, heads, shift, window, hd)
        qkv = call["qkv"]
        dout = torch.randn((SMOOTH, grid, grid, heads * hd), device="cuda").to(qkv.dtype)
        args = (qkv, dout, call["table"], call["index16"], call["mask"], window, shift,
                hd ** -0.5)
        ms, plain_ms = in_turns(
            f"window_attention_qkv_bwd {list(qkv.shape)} shift={shift} bf16",
            lambda: window_attention.window_attention_qkv_bwd(*args),
            lambda: window_attention.window_attention_qkv_bwd_reference(*args), iters=10)
        lib = library_ms(_sdpa_backward(torch, call), iters=10)
        ww = window * window
        items = SMOOTH * (grid // window) ** 2 * heads
        n_bytes = 7 * qkv[..., 0, :, :].numel() * 2 + call["table"].numel() * 4 + ww * ww * 2 \
            + (0 if call["mask"] is None else call["mask"].numel() * 4)
        case = bound(n_bytes, 12.0 * ww * ww * hd * items, BF16_FLOPS)
        log(f"    SDPA backward with attn_mask, a CUDA graph (yardstick only) {lib:.4f} ms; "
            f"bound {case['bound_ms']:.4f} ms by {case['bound_by']}; x{count} an explain step; "
            f"kernel/SDPA {ms / lib:.2f}")
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                           ("bound_ms", case["bound_ms"])):
            total[key] += count * value
        by.add(case["bound_by"])
    out["window_attention_qkv_bwd"] = {
        **total, "bound_by": "operations" if "operations" in by else "bytes"}

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by = set()
    for (hw, c), count in zip(CONVNEXT_SHAPES, CONVNEXT_DEPTHS):
        shape = (SMOOTH, hw, hw, c)
        dy, w, _ = depthwise_inputs(torch, shape, 7, False, torch.bfloat16)
        x = torch.zeros_like(dy, requires_grad=True)
        ms, plain_ms = in_turns(
            f"depthwise_conv_dx {list(shape)} k=7 bf16 (CUDA graphs of autograd's backward)",
            _graphed_grad(torch, _depthwise_module(torch, w), (x,), dy),
            _graphed_grad(torch, lambda x: depthwise.depthwise_reference(x, w), (x,), dy))
        dy_nchw = dy.permute(0, 3, 1, 2)                       # channels_last memory
        w_oihw = w.permute(2, 0, 1).reshape(c, 1, 7, 7).contiguous(
            memory_format=torch.channels_last)
        size = (SMOOTH, c, hw, hw)
        lib = library_ms(lambda: torch.nn.grad.conv2d_input(size, w_oihw, dy_nchw, padding=3,
                                                            groups=c))
        case = bound(2 * dy.numel() * 2 + w.numel() * 2, 2.0 * 49 * dy.numel(), BF16_FLOPS)
        log(f"    torch.nn.grad.conv2d_input(groups=C) (yardstick only) {lib:.4f} ms; bound "
            f"{case['bound_ms']:.4f} ms by {case['bound_by']}; x{count} an explain step")
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                           ("bound_ms", case["bound_ms"])):
            total[key] += count * value
        by.add(case["bound_by"])
    out["depthwise_conv_dx"] = {**total, "bound_by": "operations" if "operations" in by else "bytes"}
    out["depthwise_conv_dx_k35"] = time_depthwise_dx_k35(torch, depthwise)
    return out


def time_depthwise_dx_k35(torch, depthwise) -> dict:
    """Phase 8a: the depthwise input gradient at the k 3 and k 5 calls of one
    explain step at a SmoothGrad batch of ``SMOOTH``: EfficientNet-B4's 28 and
    MobileNetV3-Small's 7, timed as the served module's backward and its
    plain version's, each replayed from a CUDA graph of autograd
    (``_graphed_grad``), beside ``torch.nn.grad.conv2d_input`` with
    ``groups=C`` and the bound at the bf16 peak. Not an entry of the kernels
    line (the same kernel as ``depthwise_conv_dx``): its row is in the log."""
    from ics_tpu_torch.tools.bench_depthwise import depthwise_calls

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    by = set()
    for model in (EFFICIENTNET, MOBILENET):
        step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "launches": 0}
        for (shape, k, _), count in sorted(depthwise_calls(model, SMOOTH).items()):
            c = shape[-1]
            dy, w, _ = depthwise_inputs(torch, shape, k, False, torch.bfloat16)
            x = torch.zeros_like(dy, requires_grad=True)
            ms, plain_ms = in_turns(
                f"depthwise_conv_dx {list(shape)} k={k} bf16 ({model}; CUDA graphs of "
                "autograd's backward)",
                _graphed_grad(torch, _depthwise_module(torch, w), (x,), dy),
                _graphed_grad(torch, lambda x: depthwise.depthwise_reference(x, w), (x,), dy),
                iters=10)
            dy_nchw = dy.permute(0, 3, 1, 2)                   # channels_last memory
            w_oihw = w.permute(2, 0, 1).reshape(c, 1, k, k).contiguous(
                memory_format=torch.channels_last)
            size = (shape[0], c, shape[1], shape[2])
            lib = library_ms(lambda: torch.nn.grad.conv2d_input(
                size, w_oihw, dy_nchw, padding=k // 2, groups=c), iters=10)
            case = bound(2 * dy.numel() * 2 + w.numel() * 2, 2.0 * k * k * dy.numel(),
                         BF16_FLOPS)
            log(f"    conv2d_input(groups=C) (yardstick only) {lib:.4f} ms; bound "
                f"{case['bound_ms']:.4f} ms by {case['bound_by']}; x{count} an explain step; "
                f"kernel/conv2d_input {ms / lib:.2f}")
            for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib),
                               ("bound_ms", case["bound_ms"])):
                step[key] += count * value
            step["launches"] += count
            by.add(case["bound_by"])
        log(f"  depthwise_conv_dx k 3/5, {model}: {step['launches']} launches an explain step "
            f"at n = {SMOOTH}: kernel {step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, "
            f"conv2d_input {step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms")
        for key in total:
            total[key] += step[key]
    log(f"  depthwise_conv_dx k 3/5, both models: {json.dumps(total)}")
    return {**total, "bound_by": "operations" if "operations" in by else "bytes"}


def time_explain_in_turns(torch, rounds: int = 3) -> None:
    """Phase 8b: EfficientNet-B4's bf16 explain step at n = ``SMOOTH`` on one
    engine, kernel path and plain path in turns (kernel, plain, plain,
    kernel, ``rounds`` times), host clock from the call to its answer."""
    import statistics

    from ics_tpu_torch.nn.layers import set_use_kernels
    from ics_tpu_torch.runtime.engine import InferenceEngine

    canvas, sizes = _explain_image()
    engine = InferenceEngine(EFFICIENTNET, precision="bf16", buckets=(1,), canvas=512,
                             state_dict=_model_state(torch, EFFICIENTNET))
    engine.warmup()
    runs = {"kernel": [], "plain": []}

    def explain(path: str, record: bool = True) -> None:
        set_use_kernels(engine.model, path == "kernel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.explain_staged(canvas, sizes, smooth_samples=SMOOTH, seed=3)
        if record:
            runs[path].append(round((time.perf_counter() - t0) * 1e3, 2))

    for path in ("kernel", "plain", "kernel", "plain"):
        explain(path, record=False)
    for _ in range(rounds):
        for path in ("kernel", "plain", "plain", "kernel"):
            explain(path)
    set_use_kernels(engine.model, True)
    log(f"  explain {EFFICIENTNET} bf16 n={SMOOTH} in turns (host clock, ms): kernel path "
        f"{runs['kernel']} (median {statistics.median(runs['kernel']):.1f}), plain path "
        f"{runs['plain']} (median {statistics.median(runs['plain']):.1f})")
    del engine
    torch.cuda.empty_cache()


# what one explain step of each model launches: (forward kernel, its count, backward kernel)
EXPLAIN_KERNELS = {CONVNEXT: ("depthwise_conv", sum(CONVNEXT_DEPTHS), "depthwise_conv_dx"),
                   SWIN: ("window_attention", sum(SWIN_DEPTHS), "window_attention_bwd"),
                   EFFICIENTNET: ("depthwise_conv", None, "depthwise_conv_dx")}


def _explain_image() -> tuple:
    """One seeded photograph-like image (the latency budget's JPEG at 320 px),
    decoded and staged as the service stages it."""
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch
    from ics_tpu_torch.runtime.latency_budget import _reference_jpeg

    return stage_batch([decode_image(_reference_jpeg(side=320, seed=5))], canvas=None)


def _model_state(torch, name: str, num_classes: int = 1000, seed: int = 0) -> dict:
    """Random weights of ``name`` from ``seed``; ConvNeXt's layer scale set to
    0.5 (at 1e-6 it would hide the blocks, and their kernel, from the logits)."""
    from ics_tpu_torch.models.registry import get_model

    model = get_model(name).build(num_classes=num_classes)
    model.init_weights(torch.Generator().manual_seed(seed))
    state = model.state_dict()
    return {k: (torch.full_like(v, 0.5) if k.endswith(".gamma") else v) for k, v in state.items()}


def check_explain(torch) -> dict:
    """Phase 8b: the explain step at full width on the card, kernel path
    against the same engine's plain path (``use_kernel = False``): ConvNeXt-T,
    Swin-T and EfficientNet-B4 in fp32 and bf16 at n = 1 and ``SMOOTH``. Top-5
    equal; fp32 heat maps within ``EXPLAIN_FP32_TOL``, bf16 heat maps at a
    cosine of at least ``EXPLAIN_BF16_COSINE``; the forward and backward
    kernels launched on the kernel path, neither on the plain path. Then
    ViT-B/16 and ResNet-50 with fused chains raise ``KernelHasNoGradient``.
    Returns the launches of each model's explain step."""
    import numpy as np

    from ics_tpu_torch.nn.layers import set_use_kernels
    from ics_tpu_torch.ops import KernelHasNoGradient, launch_counts, reset_launch_counts
    from ics_tpu_torch.runtime.engine import InferenceEngine

    canvas, sizes = _explain_image()
    per_step = {}
    for name, (fwd, fwd_count, bwd) in EXPLAIN_KERNELS.items():
        state = _model_state(torch, name)
        for precision in ("fp32", "bf16"):
            engine = InferenceEngine(name, precision=precision, buckets=(1,), canvas=512,
                                     state_dict=state)
            engine.warmup()    # as a server: the kernels' operands cached under inference_mode
            for n in (1, SMOOTH):
                results = {}
                for path in ("kernel", "plain"):
                    set_use_kernels(engine.model, path == "kernel")
                    engine.explain_staged(canvas, sizes, smooth_samples=n, seed=3)   # warm
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    results[path] = engine.explain_staged(canvas, sizes, smooth_samples=n,
                                                          seed=3)
                    results[path + "_ms"] = (time.perf_counter() - t0) * 1e3
                    results[path + "_launches"] = launch_counts()
                set_use_kernels(engine.model, True)
                (ki, ks, kh), (pi, ps, ph) = results["kernel"], results["plain"]
                launched = results["kernel_launches"]
                gap = float(np.abs(kh - ph).max())
                cosine = float((kh * ph).sum() / max(np.linalg.norm(kh) * np.linalg.norm(ph),
                                                      1e-30))
                log(f"  explain {name} {precision} n={n}: top-5 {ki.tolist()} (plain "
                    f"{pi.tolist()}), scores max|d| {float(np.abs(ks - ps).max()):.2e}; heat "
                    f"max|d| {gap:.3e}, cosine {cosine:.6f}; {launched[fwd]} {fwd} and "
                    f"{launched[bwd]} {bwd} launches; kernel path {results['kernel_ms']:.1f} ms, "
                    f"plain path {results['plain_ms']:.1f} ms (host clock, one step)")
                if not np.array_equal(ki, pi):
                    fail(f"explain {name} {precision} n={n}: top-5 {ki} on the kernel path, "
                         f"{pi} on the plain path")
                if kh.shape != (16, 16) or not np.isfinite(kh).all() \
                        or (gap > EXPLAIN_FP32_TOL if precision == "fp32"
                            else cosine < EXPLAIN_BF16_COSINE):
                    fail(f"explain {name} {precision} n={n}: heat maps disagree (max|d| {gap}, "
                         f"cosine {cosine})")
                if launched[bwd] < 1 or launched[fwd] < 1 or launched[fwd] != launched[bwd] \
                        or (fwd_count is not None and launched[fwd] != fwd_count):
                    fail(f"explain {name} {precision} n={n}: launches {launched}")
                if results["plain_launches"][fwd] or results["plain_launches"][bwd]:
                    fail(f"explain {name}: the plain path launched {results['plain_launches']}")
                per_step[name] = launched[bwd]
            del engine
            torch.cuda.empty_cache()
    for name, kwargs in ((VIT, {}), (RESNET, {"fused_chains": True})):
        engine = InferenceEngine(name, precision="bf16", buckets=(1,), canvas=512, **kwargs)
        try:
            engine.explain_staged(canvas, sizes)
        except KernelHasNoGradient as exc:
            log(f"  explain {name} {kwargs}: KernelHasNoGradient ({exc})")
        else:
            fail(f"explain {name} {kwargs} did not raise KernelHasNoGradient")
        del engine
        torch.cuda.empty_cache()
    return per_step


def _png(seed: int = 5, side: int = 300) -> bytes:
    from PIL import Image

    from ics_tpu_torch.runtime.decode import decode_image
    from ics_tpu_torch.runtime.latency_budget import _reference_jpeg

    buf = io.BytesIO()
    Image.fromarray(decode_image(_reference_jpeg(side=side, seed=seed))).save(buf, "PNG")
    return buf.getvalue()


def _register_version(db, id_amb: str, options: list, directory: str, version: int,
                      seed: int, temperature) -> str:
    """A Swin-T version of ``len(options)`` classes, weights from ``seed``,
    saved with the port's ``CheckpointManager`` and made the ambiente's
    active model; returns its id."""
    import torch

    from ics_tpu_torch.core import timezone as tz
    from ics_tpu_torch.crud import modelo_crud
    from ics_tpu_torch.db import models as m
    from ics_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    mgr.save(100, _model_state(torch, SWIN, len(options), seed), metadata={"versao": version})
    mgr.close()
    with db.session() as s:
        row = m.ModeloTreinado(
            id_amb=id_amb, nome_modelo=SWIN, versao=version, num_classes=len(options),
            class_map={o: i for i, o in enumerate(options)}, dir_checkpoint=directory, passo=100,
            metricas={"temperatura": temperature}, ativo=False, data_criado=tz.utcnow())
        s.add(row)
        s.flush()
        modelo_crud.ativar_modelo(s, str(row.id_mod))
        s.commit()
        return str(row.id_mod)


async def drive_extras(base: str, admin: tuple, database: str, tmp: str) -> dict:
    """Phase 8c over HTTP, each stretch with the launch counts set to 0 before
    it and read after it: classificar-tpu and ``?tta=true`` and
    ``explicar?suavizar=8`` on the default model; a trained Swin-T version
    (3 options, seed 1, temperature 2) through classificar-tpu and explicar;
    version 2 promoted and served; ``POST /monitor/latency-budget``."""
    import httpx

    from ics_tpu_torch.db.engine import Database

    db = Database(database)
    amb = _setup_ambiente(db, [], options=("gato", "cão", "pássaro"))
    png = _png()
    route = f"/classificacoes/ambiente/{amb['id_amb']}"
    files = {"file": ("explain.png", png, "image/png")}
    out = {"png": png, "amb": amb}
    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        async def login(user, password):
            r = await c.post("/auth/login", data={"username": user, "password": password})
            r.raise_for_status()
            c.cookies.clear()
            return {"Authorization": f"Bearer {r.json()['access_token']}"}

        h_admin = await login(*admin)
        h = await login(amb["email"], amb["password"])

        async def stretch(key, calls):
            (await c.post("/inferencia/kernels/zerar", headers=h_admin)).raise_for_status()
            t0 = time.perf_counter()
            answers = []
            for path in calls:
                r = await c.post(route + path, files=files, headers=h)
                if r.status_code != 200:
                    fail(f"serving extras: POST {path} answered {r.status_code}: {r.text[:300]}\n"
                         f"{(Path(tmp) / 'server.log').read_text()[-6000:]}")
                answers.append(r.json())
            seconds = time.perf_counter() - t0
            st = (await c.get("/inferencia/status", headers=h_admin)).json()
            out[key] = {"answers": answers, "launches": st["kernel_launches"], "s": seconds}

        await stretch("default", ["/classificar-tpu", "/classificar-tpu?tta=true",
                                  "/explicar?suavizar=8"])
        _register_version(db, amb["id_amb"], amb["options"], f"{tmp}/v1", 1, 1, TEMPERATURE)
        await stretch("trained_v1", ["/classificar-tpu", "/explicar"])
        out["v1_log"] = (Path(tmp) / "server.log").read_text()
        _register_version(db, amb["id_amb"], amb["options"], f"{tmp}/v2", 2, 2, None)
        await stretch("trained_v2", ["/classificar-tpu"])
        t0 = time.perf_counter()
        while "stopped evicted" not in (Path(tmp) / "server.log").read_text():
            if time.perf_counter() - t0 > 60:
                fail("serving extras: version 1 was not stopped within 60 s of version 2")
            await asyncio.sleep(0.25)
        out["evicted_s"] = time.perf_counter() - t0
        out["log"] = (Path(tmp) / "server.log").read_text()
        r = await c.post("/monitor/latency-budget", headers=h_admin)
        r.raise_for_status()
        out["budget"] = r.json()
        out["metrics"] = (await c.get("/monitor/metrics")).text
    return out


def check_extras(torch, card: str) -> dict:
    """Phase 8c's verdict, against the same computations in this process on
    the card (the server's weights: seed 0 for the default model, seeds 1 and
    2 for the versions; fp32, as the server serves): returns the launches of
    the phase per kernel."""
    import numpy as np

    from ics_tpu_torch.nn.layers import set_use_kernels
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch
    from ics_tpu_torch.runtime.engine import InferenceEngine

    with tempfile.TemporaryDirectory(prefix="ics_tpu_torch_smoke_") as tmp:
        with serving(tmp, TPU_DEFAULT_MODEL=CONVNEXT, TPU_FUSED_CHAINS="false",
                     TPU_PRECISION="fp32") as (base, admin, database, up_s):
            log(f"  server up in {up_s:.1f} s ({CONVNEXT}, fp32)")
            drive = asyncio.run(drive_extras(base, admin, database, tmp))
    launches = {}
    for key in ("default", "trained_v1", "trained_v2"):
        st = drive[key]
        log(f"  {key}: {st['s']:.2f} s for {len(st['answers'])} requests; launches "
            f"{json.dumps({k: v for k, v in st['launches'].items() if v})}")
        for k, v in st["launches"].items():
            launches[k] = launches.get(k, 0) + v
    plain, tta, explain = drive["default"]["answers"]
    staged = stage_batch([decode_image(drive["png"])], canvas=None)

    # TTA: the mean of the image's and the flipped image's probabilities
    engine = InferenceEngine(CONVNEXT, precision="fp32", buckets=(1,), canvas=512)
    with torch.inference_mode():
        x = engine._preprocess(*engine._to_device(*staged), False)
        p = torch.softmax(engine.model.apply_folded(x).float(), -1)[0]
        pf = torch.softmax(engine.model.apply_folded(x.flip(2)).float(), -1)[0]
    mean = ((p + pf) * 0.5).cpu().numpy()
    p = p.cpu().numpy()
    tta_gap = max(abs(s - mean[c]) for c, s in zip(tta["top_classes"], tta["scores"]))
    plain_gap = max(abs(s - p[c]) for c, s in zip(plain["top_classes"], plain["scores"]))
    order = np.argsort(-mean)[:5].tolist()
    log(f"  classificar-tpu: top-5 {plain['top_classes']}, scores within {plain_gap:.2e} of "
        f"this process's; ?tta=true: top-5 {tta['top_classes']} (the mean's {order}), scores "
        f"within {tta_gap:.2e} of the mean of the image's and its flip's (tol {TTA_TOL:g})")
    if not tta.get("tta") or tta_gap > TTA_TOL or plain_gap > TTA_TOL:
        fail(f"serving extras: classificar-tpu {plain}, ?tta=true {tta}")
    heat = np.asarray(explain["mapa_saliencia"])
    log(f"  explicar?suavizar=8: grid {heat.shape}, in [{heat.min():.3f}, {heat.max():.3f}], "
        f"metodo {explain['metodo']}, suavizacao {explain.get('suavizacao')}; latency_ms of "
        f"the answers: classificar-tpu {plain['latency_ms']}, ?tta=true {tta['latency_ms']}, "
        f"explicar?suavizar=8 {explain['latency_ms']}")
    if heat.shape != (16, 16) or not np.isfinite(heat).all() or heat.min() < 0 \
            or heat.max() > 1 or explain.get("suavizacao") != 8:
        fail(f"serving extras: explicar answered {explain}")
    want = {"default": ("depthwise_conv", "depthwise_conv_dx"),
            "trained_v1": ("window_attention", "window_attention_bwd")}
    for key, kernels in want.items():
        got = drive[key]["launches"]
        if any(got[k] < 1 for k in kernels):
            fail(f"serving extras: the {key} stretch launched {got}")

    # the trained version: its option labels, scores softmax(logits / T) of the
    # plain fp32 forward of its weights
    amb = drive["amb"]
    classify, explained = drive["trained_v1"]["answers"]
    versions = {}
    for version, seed, temperature in ((1, 1, TEMPERATURE), (2, 2, 1.0)):
        eng = InferenceEngine(SWIN, num_classes=3, precision="fp32", buckets=(1,), canvas=512,
                              state_dict=_model_state(torch, SWIN, 3, seed))
        set_use_kernels(eng.model, False)
        with torch.inference_mode():
            x = eng._preprocess(*eng._to_device(*staged), False)
            logits = eng.model.apply_folded(x).float()[0]
        versions[version] = torch.softmax(logits / temperature, -1).cpu().numpy()
        del eng
    torch.cuda.empty_cache()
    for version, answer in ((1, classify), (2, drive["trained_v2"]["answers"][0])):
        by_option = {o["id_opc"]: o["score"] for o in answer["opcoes"]}
        gap = max(abs(by_option[o] - versions[version][i]) for i, o in enumerate(amb["options"]))
        log(f"  trained version {answer.get('modelo_versao')}: options "
            f"{[(o['texto_opcao'], round(o['score'], 6)) for o in answer['opcoes']]}, "
            f"temperatura {answer.get('temperatura')}; scores within {gap:.2e} of "
            f"softmax(logits / T) of the plain fp32 forward (tol {TRAINED_TOL:g})")
        if answer.get("modelo_versao") != version or len(by_option) != 3 or gap > TRAINED_TOL:
            fail(f"serving extras: version {version} answered {answer}")
    if classify.get("temperatura") != TEMPERATURE:
        fail(f"serving extras: version 1 answered temperatura {classify.get('temperatura')}")
    heat = np.asarray(explained["mapa_saliencia"])
    log(f"  version 1 (Swin-T): latency_ms of the answers: classificar-tpu "
        f"{classify['latency_ms']}, explicar "
        f"{explained['latency_ms']}")
    if heat.shape != (16, 16) or explained.get("modelo_versao") != 1 \
            or len(explained.get("opcoes", [])) != 3:
        fail(f"serving extras: explicar on version 1 answered {explained}")
    evicted = [line for line in drive["log"].splitlines() if "evicted" in line]
    log(f"  version 2 promoted: version 1 stopped {drive['evicted_s']:.2f} s after version 2 "
        f"first answered; " + " | ".join(line.split(" - ")[-1] for line in evicted))

    budget = drive["budget"]
    log(f"  POST /monitor/latency-budget ({card}): " + json.dumps(budget["componentes"]))
    log(f"    lines: {json.dumps(budget['orcamento'])}; violations {budget['violacoes']}")
    if not budget["dentro_do_orcamento"] or "latency_budget_device_step_b8_ms" \
            not in drive["metrics"]:
        fail(f"serving extras: latency budget {budget}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "ics_tpu_torch").is_dir():
        fail(f"ics_tpu_torch not found beside {Path(__file__).name}; run from a checkout")
    sys.path.insert(0, str(ROOT))
    from ics_tpu_torch import disable_tf32
    from ics_tpu_torch.ops import (
        _build,
        attention,
        bottleneck,
        depthwise,
        normalize,
        window_attention,
    )

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
        "window_attention": check_window(torch, window_attention),
        "flash_attention_bf16_exp": check_bf16_exp(torch, attention),
    }
    dw_errs = check_depthwise(torch, depthwise)
    errs["depthwise_conv"], errs["depthwise_conv_k35"] = dw_errs["k7"], dw_errs["k35"]

    log("[4] CUDA-event times at the bucket-32 shapes, and the card's bound:")
    times = {
        "flash_attention": time_attention(torch, attention),
        "bottleneck_chain": time_chain(torch, bottleneck),
        "normalize_u8": time_normalize(torch, normalize),
        "depthwise_conv": time_depthwise(torch, depthwise),
        "depthwise_conv_k35": time_depthwise_k35(torch, depthwise),
        "window_attention": time_window(torch, window_attention),
        "flash_attention_bf16_exp": time_attention(torch, attention, bf16_exp=True),
    }
    torch.cuda.empty_cache()

    log("[4b] the bf16-exp variant's own path, tools.bench_vit_attn:")
    bf16_exp_launches = drive_bf16_exp_path(torch)
    torch.cuda.empty_cache()

    log(f"[5] {VIT} @384 full width in-process, kernel path against plain path:")
    check_model(torch)

    log(f"[5b] {RESNET} full width in-process, fused chains against unfused:")
    check_resnet(torch)

    log(f"[5c] {CONVNEXT}, {SWIN}, {MOBILENET}, {EFFICIENTNET} full width in-process, "
        "kernels against plain and library versions:")
    check_new_models(torch)

    log("[5d] the device-decode lane on the card (entropy decode on the host, the rest on "
        "the device):")
    check_device_decode(torch)
    log("[5d] restart segments on worker threads (host):")
    check_threaded_decode()

    log(f"[5e] {', '.join(DENSE_REGNET)} full width in-process (no kernel of the port on "
        "their paths), and the pretrained import on the card:")
    t5e = time.perf_counter()
    check_dense_regnet(torch)
    log(f"  [5e] took {time.perf_counter() - t5e:.1f} s")

    log(f"[6] main paths: python -m ics_tpu_torch.main serving {RESNET} (fused chains, "
        f"TPU_DEVICE_DECODE at its default: on), {VIT}, {CONVNEXT}, {SWIN} and {MOBILENET}, "
        "classify over HTTP:")
    drive = serve_and_drive()
    launches = check_drive(drive)
    check_served_answers(torch, drive)
    launches["flash_attention_bf16_exp"] = bf16_exp_launches

    log(f"[7] the ingestion front: python -m ics_tpu_torch.main ({RESNET}, fused chains) "
        "syncing a fake NextCloud with classify-on-sync and embed-on-sync, then the "
        "similarity routes:")
    launches["bottleneck_chain"] += check_ingestion(torch)

    log(f"[8] the serving extras ({card}):")
    t8 = time.perf_counter()
    log("[8a] the backward kernels against autograd of their plain versions:")
    bwd_errs = check_backward(torch, window_attention, depthwise)
    errs.update(bwd_errs)
    times.update(time_backward(torch, window_attention, depthwise))
    torch.cuda.empty_cache()
    log(f"  [8a] took {time.perf_counter() - t8:.1f} s")
    t8b = time.perf_counter()
    log(f"[8b] explain at full width in-process ({CONVNEXT}, {SWIN}, {EFFICIENTNET}; fp32 and "
        f"bf16; n = 1 and {SMOOTH}), kernel path against plain path:")
    per_step = check_explain(torch)
    time_explain_in_turns(torch)
    log(f"  backward launches an explain step: {json.dumps(per_step)}; [8b] took "
        f"{time.perf_counter() - t8b:.1f} s")
    t8c = time.perf_counter()
    log(f"[8c] python -m ics_tpu_torch.main serving {CONVNEXT} (fp32): classificar-tpu, "
        "?tta=true, explicar?suavizar=8, a trained Swin-T version and its successor, "
        "POST /monitor/latency-budget:")
    for name, count in check_extras(torch, card).items():
        launches[name] = launches.get(name, 0) + count
    # the kernels line names the backward of the window kernel after its entry
    launches["window_attention_qkv_bwd"] = launches.pop("window_attention_bwd")
    log(f"  [8c] took {time.perf_counter() - t8c:.1f} s; phase [8] {time.perf_counter() - t8:.1f} s "
        f"on {card}")

    sources = {
        "flash_attention": ("ics_tpu_torch/ops/csrc/flash_attention.cu",
                            "ics_tpu/ops/attention.py:170"),
        "bottleneck_chain": ("ics_tpu_torch/ops/csrc/bottleneck_chain.cu",
                             "ics_tpu/ops/pallas_bottleneck.py:164"),
        "normalize_u8": ("ics_tpu_torch/ops/csrc/normalize_u8.cu",
                         "ics_tpu/ops/pallas_preproc.py:67"),
        "depthwise_conv": ("ics_tpu_torch/ops/csrc/depthwise_conv.cu",
                           "ics_tpu/ops/pallas_depthwise.py:88"),
        "depthwise_conv_k35": ("ics_tpu_torch/ops/csrc/depthwise_conv.cu",
                               "ics_tpu/ops/pallas_depthwise.py:88"),
        "window_attention": ("ics_tpu_torch/ops/csrc/window_attention.cu",
                             "scripts/proto_window_attn.py:82"),
        "flash_attention_bf16_exp": ("ics_tpu_torch/ops/csrc/flash_attention.cu",
                                     "scripts/bench_vit_attn.py:104"),
        "window_attention_qkv_bwd": ("ics_tpu_torch/ops/csrc/window_attention_bwd.cu",
                                 "scripts/proto_window_attn.py:82"),
        "depthwise_conv_dx": ("ics_tpu_torch/ops/csrc/depthwise_conv.cu",
                              "ics_tpu/ops/pallas_depthwise.py:88"),
    }
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        **{key: times[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
    } for name, (source, replaces) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
