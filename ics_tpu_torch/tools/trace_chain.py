"""Where a thread block's time goes inside the bottleneck-chain kernel, by clock stamps.

    python -m ics_tpu_torch.tools.trace_chain [--batch 32]

Builds ``ops/csrc/bottleneck_chain.cu`` once more with ``-DICS_CHAIN_TRACE``
(beside the serving library, which carries no stamps), runs one bottleneck of
each ResNet-50 chain, [batch, 56, 56, 256] at Cm 64 and [batch, 28, 28, 512]
at Cm 128 in bf16 from seed 0, through the ``wgmma`` kernel, and reads the
stamps that the first lane of each consumer warpgroup of every block took
where a product or its epilogue ends. Prints the card's name and power limit,
then for each shape the median over the blocks, in microseconds of the
multiprocessor's clock, of: the first 1x1 (its products and its epilogues
apart), the wait at the barrier behind it, the 3x3's products and epilogue,
the second barrier, the last 1x1 (products and epilogues with the shortcut
apart); a block's whole span; and, by the card's own timer, how the blocks
lie in the launch (when the first and the second round start and end). The
same as one JSON line a shape. The stamps cost a few dozen cycles each: read
the phases as shares.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from ics_tpu_torch.ops import _build, bottleneck

SHAPES = (((56, 56, 256), 64), ((28, 28, 512), 128))   # (H, W, C), Cm of ResNet-50's chains
TRACE_BLOCKS, TRACE_SLOTS = 1024, 12                   # kTraceBlocks, kTraceSlots of the source
PHASES = ("first 1x1", "first 1x1: products", "first 1x1: epilogues", "barrier behind it",
          "3x3: products", "3x3: epilogue", "barrier behind the 3x3", "last 1x1",
          "last 1x1: products", "last 1x1: epilogues", "block")


def traced_library() -> ctypes.CDLL:
    """The kernel library with the clock stamps compiled in."""
    out = _build.library_path("bottleneck_chain").with_name("libbottleneck_chain-trace.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DICS_CHAIN_TRACE", "-o", str(out),
           str(_build.CSRC / "bottleneck_chain.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {done.returncode}):\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    served = bottleneck._kernel()
    lib.ics_bottleneck_block.argtypes = served.ics_bottleneck_block.argtypes
    lib.ics_bottleneck_block.restype = ctypes.c_int
    lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ics_cuda_error_string.restype = ctypes.c_char_p
    lib.ics_chain_trace.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.ics_chain_trace.restype = ctypes.c_int
    return lib


def random_block(c: int, cm: int) -> dict:
    """One bottleneck's packed weights on the card, scaled so that the output stays O(1)."""
    g = torch.Generator().manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    packed = {"w1": (randn(1, c, cm) * (2.0 / c) ** 0.5).bfloat16(),
              "w2": (randn(1, 9 * cm, cm) * (2.0 / (9 * cm)) ** 0.5).bfloat16(),
              "w3": (randn(1, cm, c) * 0.25 * (1.0 / cm) ** 0.5).bfloat16()}
    for i, width in ((1, cm), (2, cm), (3, c)):
        packed[f"s{i}"] = 1.0 + 0.1 * randn(1, 1, width)
        packed[f"b{i}"] = 0.1 * randn(1, 1, width)
    return {k: v.cuda() for k, v in packed.items()}


def trace_shape(lib: ctypes.CDLL, batch: int, hwc: tuple, cm: int) -> dict:
    h, w, c = hwc
    g = torch.Generator().manual_seed(1)
    x = (0.5 * torch.randn((batch, h, w, c), generator=g)).bfloat16().cuda()
    packed = random_block(c, cm)
    served = bottleneck._kernel
    bottleneck._kernel = lambda: lib          # the wrapper's own checks and geometry, traced library
    try:
        for _ in range(3):                    # the stamps of the last launch stay
            bottleneck.bottleneck_chain(x, packed)
        torch.cuda.synchronize()
    finally:
        bottleneck._kernel = served
    raw = (ctypes.c_longlong * (TRACE_BLOCKS * 2 * TRACE_SLOTS))()
    rc = lib.ics_chain_trace(raw)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed (cudaError {rc})")
    th = bottleneck.pick_tile_rows(h, w, cm, batch)
    blocks = min(TRACE_BLOCKS, -(-h // th) * batch)
    stamps = torch.tensor(list(raw), dtype=torch.int64).reshape(TRACE_BLOCKS, 2, TRACE_SLOTS)
    stamps = stamps[:blocks]
    t = stamps[..., :7].double()
    first_gemm, last_gemm = stamps[..., 8].double(), stamps[..., 9].double()
    cycles = torch.stack([
        t[..., 1] - t[..., 0], first_gemm, t[..., 1] - t[..., 0] - first_gemm,
        t[..., 2] - t[..., 1], t[..., 3] - t[..., 2], t[..., 4] - t[..., 3],
        t[..., 5] - t[..., 4], t[..., 6] - t[..., 5], last_gemm,
        t[..., 6] - t[..., 5] - last_gemm, t[..., 6] - t[..., 0]], dim=-1)   # [blocks, 2, 11]
    start_ns, end_ns = stamps[..., 10].double(), stamps[..., 11].double()
    span_ns = (end_ns - start_ns).median().item()
    mhz = cycles[..., -1].median().item() / span_ns * 1e3
    origin = start_ns.min().item()
    starts = sorted(((start_ns[:, 0] - origin) / 1e3).tolist())
    ends = sorted(((end_ns.max(dim=1).values - origin) / 1e3).tolist())
    result = {"shape": [batch, h, w, c], "cm": cm, "tile_rows": th, "blocks": blocks,
              "clock_mhz": mhz, "launch_us": ends[-1],
              "block_starts_us": {"first": starts[0], "median": statistics.median(starts),
                                  "last": starts[-1]},
              "block_ends_us": {"first": ends[0], "median": statistics.median(ends),
                                "last": ends[-1]},
              "phases_us": {}}
    print(f"[{batch}, {h}, {w}, {c}] Cm={cm}: {blocks} blocks of {th} rows, clock {mhz:.0f} MHz; "
          f"by the card's timer the launch takes {ends[-1]:.1f} us from its first block's "
          f"start, blocks start at {starts[0]:.1f} / {statistics.median(starts):.1f} / "
          f"{starts[-1]:.1f} us and end at {ends[0]:.1f} / {statistics.median(ends):.1f} / "
          f"{ends[-1]:.1f} us (first / median / last)")
    for i, name in enumerate(PHASES):
        per_wg = [cycles[:, wg, i].median().item() / mhz for wg in range(2)]
        result["phases_us"][name] = per_wg
        print(f"  {name:<24} {per_wg[0]:8.2f} {per_wg[1]:8.2f} us (warpgroup 0, 1; median of "
              f"the blocks)")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib = traced_library()
    for hwc, cm in SHAPES:
        print(json.dumps({"card": card, **trace_shape(lib, args.batch, hwc, cm)}), flush=True)


if __name__ == "__main__":
    main()
