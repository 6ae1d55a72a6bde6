"""Kernel 6 (window attention) at every window attention of a Swin forward, on the card.

    python -m ics_tpu_torch.tools.bench_window [--model swin_tiny] [--bucket 32 8 1]
        [--groups]

For each bucket and each distinct call of a forward of ``--model``
(``swin_tiny``: per stage unshifted and shifted, 12 launches a forward;
``swin_micro``: windows of 16 tokens, head_dim 16, 3 launches), bf16, inputs
from seed 0, times by CUDA events in turns (the order, then the order
reversed):

- ``qkv``: ``window_attention_qkv`` on the qkv product, as Swin serves it;
- ``glue_4d``: what Swin ran around the kernel before it read the qkv
  product: roll, window partition, q/k/v copies, ``q * scale``, the bias
  gather, ``window_attention`` (this kernel through its 4-D entry), head
  merge, window merge, roll back;
- ``4d``: ``window_attention`` alone on partitioned q, k, v and bias;
- ``plain``: the plain version of the qkv entry;
- ``sdpa``: ``F.scaled_dot_product_attention`` with bias and mask as a bf16
  ``attn_mask`` on the partitioned inputs (a yardstick, used nowhere in
  the port).

Beside them: the least time the card could take (q, k, v read once, the
output written once, table, index and mask read once, at 3.35 TB/s), the
heads a work item takes (``pick_head_group``) and the host's time to launch
the qkv entry. ``--groups`` also times the qkv entry at every head group
that fits, each forced by standing in for ``pick_head_group`` during the
call. Prints the card's name and power limit first and one JSON line at the
end.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from unittest import mock

import torch
import torch.nn.functional as F

from ics_tpu_torch.ops import window_attention as wa
from ics_tpu_torch.tools.bench_depthwise import host_us, queued_ms
from ics_tpu_torch.tools.profile_step import events_ms

# (grid, heads, depth) per stage, window, head_dim: the model constructors' widths
MODELS = {
    "swin_tiny": ([(56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2)], 7, 32),
    "swin_micro": ([(16, 2, 1), (8, 4, 2)], 4, 16),
}
HBM_BYTES_S = 3.35e12
SMEM_MAX = 232448 - 256


def swin_calls(model: str = "swin_tiny"):
    """(grid, heads, shift, count, window, head_dim) of one forward: per stage
    the odd blocks shifted by half a window, none where the grid is one
    window."""
    stages, window, hd = MODELS[model]
    for grid, heads, depth in stages:
        shifted = depth // 2 if grid > window else 0
        for shift, count in ((0, depth - shifted), (window // 2, shifted)):
            if count:
                yield grid, heads, shift, count, window, hd


def make_call(batch: int, grid: int, heads: int, shift: int, window: int = 7, hd: int = 32,
              dtype=torch.bfloat16, seed: int = 0) -> dict:
    """One call's inputs on the card: the qkv product [B, G, G, 3, H, hd] as the
    qkv GEMM leaves it, Swin's table, index and mask, and the partitioned q
    (scaled), k, v and bias that the 4-D entry and the yardstick take."""
    from ics_tpu_torch.models.swin import _relative_position_index, _shift_attn_mask

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((batch, grid, grid, 3 * heads * hd), generator=g).to(dtype)
    qkv = qkv.cuda().unflatten(-1, (3, heads, hd))
    table = (0.02 * torch.randn(((2 * window - 1) ** 2, heads), generator=g)).cuda()
    index = torch.from_numpy(_relative_position_index(window)).cuda()
    mask = (torch.from_numpy(_shift_attn_mask(grid, window, shift)).cuda() if shift else None)
    call = {"qkv": qkv, "table": table, "index": index, "index16": index.to(torch.int16),
            "mask": mask, "shift": shift, "window": window}
    call.update(zip(("q", "k", "v", "bias"), partitioned(call)))
    return call


def partitioned(call: dict) -> tuple:
    """Roll, partition, q/k/v copies, q * scale and the bias gather: the glue
    in front of the 4-D entry."""
    qkv, shift = call["qkv"], call["shift"]
    b, grid, _, _, h, hd = qkv.shape
    x = qkv.reshape(b, grid, grid, 3 * h * hd)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    win = wa.window_partition(x, call["window"])
    bn, ww, _ = win.shape
    q, k, v = (t.contiguous() for t in win.reshape(bn, ww, 3, h, hd).permute(2, 0, 3, 1, 4)
               .unbind(0))
    return q * hd ** -0.5, k, v, wa.relative_bias(call["table"], call["index"])


def glue_4d(call: dict) -> torch.Tensor:
    """The 4-D entry with the glue it needs around it, as Swin ran it before."""
    qkv, shift = call["qkv"], call["shift"]
    b, grid, _, _, h, hd = qkv.shape
    q, k, v, bias = partitioned(call)
    out = wa.window_attention(q, k, v, bias, call["mask"])
    bn, _, ww, _ = out.shape
    y = wa.window_merge(out.transpose(1, 2).reshape(bn, ww, h * hd), call["window"], grid, b)
    return torch.roll(y, (shift, shift), dims=(1, 2)) if shift else y


def qkv_entry(call: dict) -> torch.Tensor:
    return wa.window_attention_qkv(call["qkv"], call["table"], call["index16"], call["mask"],
                                   call["window"], call["shift"], call["qkv"].shape[-1] ** -0.5)


def with_group(call: dict, group: int) -> torch.Tensor:
    """The qkv entry with ``group`` heads a work item in place of the picked one."""
    with mock.patch.object(wa, "pick_head_group", lambda *args: group):
        return qkv_entry(call)


def plain(call: dict) -> torch.Tensor:
    return wa.window_attention_qkv_reference(call["qkv"], call["table"], call["index"],
                                             call["mask"], call["window"], call["shift"],
                                             call["qkv"].shape[-1] ** -0.5)


def sdpa_mask(call: dict) -> torch.Tensor:
    """bias + mask as one bf16 [Bn, H, ww, ww] ``attn_mask``."""
    q, bias, mask = call["q"], call["bias"], call["mask"]
    bn, h, ww, _ = q.shape
    attn_mask = bias[None].expand(bn, h, ww, ww)
    if mask is not None:
        n_w = mask.shape[0]
        attn_mask = (attn_mask.reshape(bn // n_w, n_w, h, ww, ww)
                     + mask[None, :, None]).reshape(bn, h, ww, ww)
    return attn_mask.to(call["q"].dtype).contiguous()


def bound_ms(call: dict) -> float:
    """q, k, v read once and the output written once, table, index and mask
    read once, at the card's memory rate (the operations take a tenth of it)."""
    qkv, mask = call["qkv"], call["mask"]
    n_bytes = qkv.numel() * qkv.element_size() * 4 // 3 + call["table"].numel() * 4 \
        + call["index16"].numel() * 2 + (0 if mask is None else mask.numel() * 4)
    return n_bytes / HBM_BYTES_S * 1e3


def head_group_of(call: dict) -> int:
    qkv, window = call["qkv"], call["window"]
    b, grid, _, _, h, hd = qkv.shape
    sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
    return wa.pick_head_group(b * (grid // window) ** 2, h, window * window, hd,
                              call["table"].shape[0], call["mask"] is not None, sms)


def in_turns(fns: dict, ahead: torch.Tensor, iters: int = 20, rounds: int = 2) -> dict:
    """ms a call of each, the mean of ``2 * rounds`` runs in turns: the
    order, then the order reversed."""
    for fn in fns.values():
        events_ms(fn, 3)
    runs = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            runs[name].append(queued_ms(fns[name], ahead, iters))
    return {name: sum(v) / len(v) for name, v in runs.items()}


def run(model: str = "swin_tiny", buckets=(32, 8, 1), groups: bool = False,
        iters: int = 20) -> dict:
    ahead = torch.ones((8192, 8192), device="cuda", dtype=torch.bfloat16)
    result = {}
    with torch.inference_mode():
        for bucket in buckets:
            step = {}
            rows = []
            for grid, heads, shift, count, window, hd in swin_calls(model):
                call = make_call(bucket, grid, heads, shift, window, hd)
                attn_mask = sdpa_mask(call)
                fns = {
                    "qkv": lambda: qkv_entry(call),
                    "glue_4d": lambda: glue_4d(call),
                    "4d": lambda: wa.window_attention(call["q"], call["k"], call["v"],
                                                      call["bias"], call["mask"]),
                    "plain": lambda: plain(call),
                    "sdpa": lambda: F.scaled_dot_product_attention(
                        call["q"], call["k"], call["v"], attn_mask=attn_mask, scale=1.0),
                }
                if groups:
                    for group in range(1, heads + 1):
                        if heads % group == 0 and wa.smem_bytes(
                                window * window, hd, group, call["table"].shape[0],
                                shift > 0) <= SMEM_MAX:
                            fns[f"group_{group}"] = lambda gr=group: with_group(call, gr)
                ref = plain(call).float()
                errs = {name: (fns[name]().float() - ref).abs().max().item()
                        for name in fns if name == "qkv" or name.startswith(("glue", "group"))}
                times = in_turns(fns, ahead, iters)
                row = {"grid": grid, "heads": heads, "shift": shift, "count": count,
                       "head_group": head_group_of(call), "bound_ms": bound_ms(call),
                       "host_us": host_us(fns["qkv"], 300), "max_abs_err": errs, "ms": times}
                rows.append(row)
                print(f"bucket {bucket} [{bucket},{grid},{grid},3,{heads},{hd}] shift={shift} "
                      f"x{count} head_group {row['head_group']}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                      + f" ms; bound {row['bound_ms']:.4f} ms; host {row['host_us']:.1f} us a "
                      f"launch; errors {errs}", flush=True)
                for name, ms in times.items():
                    step[name] = step.get(name, 0.0) + count * ms
                step["bound_ms"] = step.get("bound_ms", 0.0) + count * row["bound_ms"]
            print(f"bucket {bucket}, a {model} forward "
                  f"({sum(r['count'] for r in rows)} launches): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in step.items()) + " ms", flush=True)
            result[bucket] = {"calls": rows, "step": step}
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="swin_tiny")
    ap.add_argument("--bucket", type=int, nargs="+", default=[32, 8, 1])
    ap.add_argument("--groups", action="store_true",
                    help="also time the qkv entry at every head group that fits")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = run(args.model, args.bucket, args.groups, args.iters)
    print(json.dumps({"card": card, "model": args.model, "buckets": result}))


if __name__ == "__main__":
    main()
