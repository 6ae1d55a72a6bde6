"""The flash-attention kernel with and without ``bf16_exp`` on the GPU
(counterpart of ``scripts/bench_vit_attn.py``).

    python -m ics_tpu_torch.tools.bench_vit_attn [--batch 32] [--iters 50]

At ViT-B/16 @384's attention shape, [batch, 12, 577, 64] in bf16 from seed
0: the card's name and power limit, then for each variant its time by CUDA
events (in turns: exact, bf16 exp, bf16 exp, exact) and its largest error
against ``attention_reference`` (the exact plain version) on the first two
images. One JSON line at the end carries the same numbers. The script's
other variant, several query blocks in flight, changes the order of the
work and not the result, and the kernel already keeps four query tiles in
flight per block, so there is no switch for it.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ics_tpu_torch.ops.attention import attention_reference, flash_attention
from ics_tpu_torch.tools.profile_step import events_ms

SHAPE = (12, 577, 64)     # heads, tokens, head_dim of ViT-B/16 @384


def run(batch: int = 32, iters: int = 50) -> dict:
    """Times and errors of both variants; needs a CUDA device."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((batch, *SHAPE), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    variants = {"exact": False, "bf16_exp": True}
    ref = attention_reference(q[:2], k[:2], v[:2]).float()
    out = {}
    for name, flag in variants.items():
        got = flash_attention(q[:2], k[:2], v[:2], bf16_exp=flag).float()
        out[name] = {"max_abs_err": (got - ref).abs().max().item(), "ms": []}
        events_ms(lambda: flash_attention(q, k, v, bf16_exp=flag), 3)
    for name in ("exact", "bf16_exp", "bf16_exp", "exact"):
        flag = variants[name]
        out[name]["ms"].append(events_ms(lambda: flash_attention(q, k, v, bf16_exp=flag), iters))
    for rec in out.values():
        rec["ms"] = sum(rec["ms"]) / len(rec["ms"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    result = run(args.batch, args.iters)
    for name, rec in result.items():
        print(f"flash_attention [{args.batch}, 12, 577, 64] bf16 {name}: {rec['ms']:.4f} ms, "
              f"max abs err against the exact plain version {rec['max_abs_err']:.3e}")
    print(json.dumps({"card": card, "batch": args.batch, **result}))


if __name__ == "__main__":
    main()
