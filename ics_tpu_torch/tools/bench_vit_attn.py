"""The flash-attention kernel with and without ``bf16_exp`` on the GPU
(counterpart of ``scripts/bench_vit_attn.py``).

    python -m ics_tpu_torch.tools.bench_vit_attn [--batch 32] [--iters 50]
        [--heads 12] [--seq 577] [--head-dim 64]

At ViT-B/16 @384's attention shape, [batch, 12, 577, 64] in bf16 from seed
0 (or the shape the options name): the card's name and power limit, then for each variant its time by CUDA
events (in turns: exact, bf16 exp, bf16 exp, exact) and its largest error
against ``attention_reference`` (the exact plain version) on the first two
images. The same two variants are then timed through the ``mma.sync`` kernel
that head_dim 16 and 32 take (``ldmatrix`` fragments, a ``cp.async`` double
buffer): the step between the first port's kernel and the ``wgmma`` one, and
last ``F.scaled_dot_product_attention`` as a yardstick (timed here, used
nowhere in the port). One JSON line at the end carries the same numbers. The script's other variant,
several query blocks in flight, changes the order of the work and not the
result; the kernel keeps two query tiles of a head in flight per block, in
turns, so there is no switch for it.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ics_tpu_torch.ops import attention
from ics_tpu_torch.ops.attention import attention_reference, flash_attention
from ics_tpu_torch.tools.profile_step import events_ms

SHAPE = (12, 577, 64)     # heads, tokens, head_dim of ViT-B/16 @384


def run(batch: int = 32, iters: int = 50, shape: tuple = SHAPE) -> dict:
    """Times and errors of both variants, on the serving kernel and on the
    ``mma.sync`` one, and of the library yardstick; needs a CUDA device."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((batch, *shape), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scratch = torch.empty_like(q)

    def mma_sync(qq, kk, vv, out, bf16_exp):
        attention._launch(qq, kk, vv, out, None, bf16_exp, mma_sync=True)
        return out

    variants = {
        "exact": lambda qq, kk, vv, out: flash_attention(qq, kk, vv),
        "bf16_exp": lambda qq, kk, vv, out: flash_attention(qq, kk, vv, bf16_exp=True),
        "exact_mma_sync": lambda qq, kk, vv, out: mma_sync(qq, kk, vv, out, False),
        "bf16_exp_mma_sync": lambda qq, kk, vv, out: mma_sync(qq, kk, vv, out, True),
        "library_sdpa": lambda qq, kk, vv, out: F.scaled_dot_product_attention(qq, kk, vv),
    }
    ref = attention_reference(q[:2], k[:2], v[:2]).float()
    out = {}
    for name, fn in variants.items():
        got = fn(q[:2], k[:2], v[:2], scratch[:2]).float()
        out[name] = {"max_abs_err": (got - ref).abs().max().item(), "ms": []}
        events_ms(lambda: fn(q, k, v, scratch), 3)
    for pair in (("exact", "bf16_exp"), ("exact_mma_sync", "bf16_exp_mma_sync"),
                 ("exact", "library_sdpa")):
        for name in (pair[0], pair[1], pair[1], pair[0]):
            fn = variants[name]
            out[name]["ms"].append(events_ms(lambda: fn(q, k, v, scratch), iters))
    for rec in out.values():
        rec["ms"] = sum(rec["ms"]) / len(rec["ms"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--heads", type=int, default=SHAPE[0])
    ap.add_argument("--seq", type=int, default=SHAPE[1])
    ap.add_argument("--head-dim", type=int, default=SHAPE[2])
    args = ap.parse_args()
    shape = (args.heads, args.seq, args.head_dim)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    result = run(args.batch, args.iters, shape)
    for name, rec in result.items():
        print(f"flash_attention {[args.batch, *shape]} bf16 {name}: {rec['ms']:.4f} ms, "
              f"max abs err against the exact plain version {rec['max_abs_err']:.3e}")
    print(json.dumps({"card": card, "batch": args.batch, "shape": shape, **result}))


if __name__ == "__main__":
    main()
