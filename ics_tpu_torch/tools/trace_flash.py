"""Where a tile's time goes inside the flash-attention kernel, by clock stamps.

    python -m ics_tpu_torch.tools.trace_flash [--batch 32] [--bf16-exp]

Builds ``ops/csrc/flash_attention.cu`` once more with ``-DICS_FLASH_TRACE``
(beside the serving library, which carries no stamps), runs the ``wgmma``
kernel at ViT-B/16 @384's attention shape, [batch, 12, 577, 64] bf16 from
seed 0, and reads the stamps that the first lane of each consumer warpgroup
of block 0 took at seven points of every tile after an item's first. Prints
the card's name and power limit, then for each warpgroup the median cycles
of each phase of a tile (the last, ragged tile of an item apart) and of the
whole step from one tile to the next, and the same as one JSON line. The
stamps cost a few dozen cycles a tile, and the compiler may move arithmetic
across them: read the phases as shares, the sum as the tile.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from ics_tpu_torch.ops import _build, attention, stream_and_device

PHASES = ("wait for the turn", "launch S and the product before", "wait for S",
          "mask and max", "wait for the product, rescale", "exponentials and P")
SHAPE = (12, 577, 64)     # heads, tokens, head_dim of ViT-B/16 @384
TRACE_TILES = 512         # kTraceTiles of the kernel source


def traced_library() -> ctypes.CDLL:
    """The kernel library with the clock stamps compiled in."""
    out = _build.library_path("flash_attention").with_name("libflash_attention-trace.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DICS_FLASH_TRACE", "-o", str(out),
           str(_build.CSRC / "flash_attention.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {done.returncode}):\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.ics_flash_attention.argtypes = attention._kernel().ics_flash_attention.argtypes
    lib.ics_flash_attention.restype = ctypes.c_int
    lib.ics_flash_trace.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.ics_flash_trace.restype = ctypes.c_int
    return lib


def run(batch: int = 32, bf16_exp: bool = False) -> dict:
    lib = traced_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((batch, *SHAPE), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = torch.empty_like(q)
    h, s, d = SHAPE
    strides = (ctypes.c_longlong * 12)(*(list(q.stride()[:3]) * 4))
    for _ in range(3):        # the stamps of the last launch stay
        rc = lib.ics_flash_attention(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     batch, h, s, d, s, strides, int(bf16_exp), 0,
                                     *stream_and_device(q))
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * (2 * TRACE_TILES * 8))()
    if lib.ics_flash_trace(stamps) != 0:
        raise RuntimeError("could not read the stamps")
    tiles_per_item = (s + 127) // 128 - 1          # stamped tiles: all but an item's first
    items = min(TRACE_TILES // tiles_per_item, (batch * h * ((s + 127) // 128)) // 132) - 1
    result = {}
    for wg in range(2):
        rows = [[stamps[(wg * TRACE_TILES + n) * 8 + j] for j in range(7)]
                for n in range(items * tiles_per_item)]
        full = [r for n, r in enumerate(rows) if n % tiles_per_item != tiles_per_item - 1]
        ragged = [r for n, r in enumerate(rows) if n % tiles_per_item == tiles_per_item - 1]
        steps = [rows[n + 1][0] - rows[n][0] for n in range(len(rows) - 1)
                 if n % tiles_per_item < tiles_per_item - 2]
        result[f"warpgroup_{wg}"] = {
            "full_tile_cycles": {name: statistics.median(r[j + 1] - r[j] for r in full)
                                 for j, name in enumerate(PHASES)},
            "ragged_tile_cycles": {name: statistics.median(r[j + 1] - r[j] for r in ragged)
                                   for j, name in enumerate(PHASES)},
            "tile_to_tile_cycles": statistics.median(steps),
            "item_to_item_cycles": statistics.median(
                rows[(i + 1) * tiles_per_item][0] - rows[i * tiles_per_item][0]
                for i in range(items - 1)),
        }
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bf16-exp", action="store_true")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    result = run(args.batch, args.bf16_exp)
    for name, rec in result.items():
        print(f"{name}: a full tile of 128 keys, median cycles by phase:")
        for phase, cycles in rec["full_tile_cycles"].items():
            print(f"  {phase:36s} {cycles:7.0f}   (ragged last tile {rec['ragged_tile_cycles'][phase]:.0f})")
        print(f"  from one tile to the next {rec['tile_to_tile_cycles']:.0f} cycles; from one "
              f"item (5 tiles) to the next {rec['item_to_item_cycles']:.0f}")
    print(json.dumps({"card": card, "batch": args.batch, "bf16_exp": args.bf16_exp, **result}))


if __name__ == "__main__":
    main()
