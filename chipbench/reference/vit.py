"""A Vision Transformer: the class token taken after the final LayerNorm
(eps 1e-6), exact GELU, and a qkv product laid out [q | k | v], each
head's features together. Configuration keys: ``image_size``,
``patch_size``, ``hidden_size``, ``layers``, ``heads``, ``mlp_size``,
``num_classes``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference.models import Quant, Spec, conv, linear, q


def param_spec(cfg: dict) -> Spec:
    d, mlp, p = cfg["hidden_size"], cfg["mlp_size"], cfg["patch_size"]
    tokens = (cfg["image_size"] // p) ** 2 + 1
    spec: Spec = [
        ("patch_embed.weight", (d, 3, p, p), "stem", 3 * p * p),
        ("patch_embed.bias", (d,), "bias", 0),
        ("cls_token", (1, 1, d), "embed", 0),
        ("pos_embed", (1, tokens, d), "embed", 0),
    ]
    for i in range(cfg["layers"]):
        b = f"blocks.{i}"
        spec += [
            (f"{b}.ln1.weight", (d,), "ln_weight", 0), (f"{b}.ln1.bias", (d,), "bias", 0),
            (f"{b}.attn.qkv.weight", (3 * d, d), "dense", d),
            (f"{b}.attn.qkv.bias", (3 * d,), "bias", 0),
            (f"{b}.attn.proj.weight", (d, d), "dense", d),
            (f"{b}.attn.proj.bias", (d,), "bias", 0),
            (f"{b}.ln2.weight", (d,), "ln_weight", 0), (f"{b}.ln2.bias", (d,), "bias", 0),
            (f"{b}.fc1.weight", (mlp, d), "dense", d), (f"{b}.fc1.bias", (mlp,), "bias", 0),
            (f"{b}.fc2.weight", (d, mlp), "dense", mlp), (f"{b}.fc2.bias", (d,), "bias", 0),
        ]
    spec += [("ln.weight", (d,), "ln_weight", 0), ("ln.bias", (d,), "bias", 0),
             ("head.weight", (cfg["num_classes"], d), "head", d),
             ("head.bias", (cfg["num_classes"],), "zero", 0)]
    return spec


def _layer_norm(x, sd, prefix, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def features(cfg: dict, sd: dict, x: torch.Tensor, calibrate: bool = False,
             quant: Quant = None) -> torch.Tensor:
    """x [B, 3, S, S] normalised -> the class token after the final
    LayerNorm [B, D]. ``calibrate`` changes nothing: a ViT has no running
    statistics."""
    d, heads = cfg["hidden_size"], cfg["heads"]
    hd = d // heads
    p = cfg["patch_size"]
    b = x.shape[0]
    y = conv(x, sd["patch_embed.weight"], p, 0, quant, sd["patch_embed.bias"])
    y = y.flatten(2).transpose(1, 2)                                  # [B, P, D]
    y = torch.cat([sd["cls_token"].expand(b, 1, d), y], dim=1) + sd["pos_embed"]
    s = y.shape[1]
    for i in range(cfg["layers"]):
        blk = f"blocks.{i}"
        h = _layer_norm(y, sd, f"{blk}.ln1")
        qkv = linear(h, sd[f"{blk}.attn.qkv.weight"], sd[f"{blk}.attn.qkv.bias"], quant)
        qh, kh, vh = qkv.reshape(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        att = torch.softmax((q(quant, qh) @ q(quant, kh).transpose(-1, -2)) / math.sqrt(hd), -1)
        o = (q(quant, att) @ q(quant, vh)).transpose(1, 2).reshape(b, s, d)
        y = q(quant, y + linear(o, sd[f"{blk}.attn.proj.weight"], sd[f"{blk}.attn.proj.bias"],
                                quant))
        h = _layer_norm(y, sd, f"{blk}.ln2")
        h = F.gelu(linear(h, sd[f"{blk}.fc1.weight"], sd[f"{blk}.fc1.bias"], quant))
        y = q(quant, y + linear(h, sd[f"{blk}.fc2.weight"], sd[f"{blk}.fc2.bias"], quant))
    return _layer_norm(y, sd, "ln")[:, 0]


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one image: patch embedding, per block the qkv,
    projection and MLP products and the two attention products over every
    token, and the head on the class token."""
    grid = cfg["image_size"] // cfg["patch_size"]
    tokens = grid * grid + 1
    d, mlp = cfg["hidden_size"], cfg["mlp_size"]
    total = grid * grid * cfg["patch_size"] ** 2 * 3 * d
    per_block = tokens * (3 * d * d + d * d + 2 * d * mlp) + 2 * tokens * tokens * d
    return total + cfg["layers"] * per_block + d * cfg["num_classes"]
