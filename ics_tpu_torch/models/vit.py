"""Vision Transformer (counterpart of ``ics_tpu/models/vit.py``), inference only.

The patch embed is a strided convolution (cuDNN); attention goes through
the hand-written flash kernel (``ics_tpu_torch.ops.attention``) on the
serving path, and through its plain version with ``use_flash=False``.
ViT-B/16 @384 has 577 tokens (24x24 patches + cls); the kernel masks the
ragged last tile itself.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ics_tpu_torch.nn.layers import Conv2D, Dense, LayerNorm, gelu, trunc_normal_
from ics_tpu_torch.ops.attention import attention_reference, flash_attention


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} does not split into {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Dense(dim, dim * 3, device=device)
        self.proj = Dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor, use_flash: bool = True) -> torch.Tensor:
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
        attend = flash_attention if use_flash else attention_reference
        out = attend(q, k, v)                                  # [B, H, S, hd]
        return self.proj(out.transpose(1, 2).reshape(b, s, self.dim))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.fc1 = Dense(dim, dim * mlp_ratio, device=device)
        self.fc2 = Dense(dim * mlp_ratio, dim, device=device)

    def forward(self, x: torch.Tensor, use_flash: bool = True) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), use_flash)
        y = gelu(self.fc1(self.ln2(x)))
        return x + self.fc2(y)


class ViT(nn.Module):
    def __init__(self, image_size: int = 384, patch_size: int = 16,
                 dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_classes: int = 1000, device=None):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim = dim
        self.num_classes = num_classes
        self.num_patches = (image_size // patch_size) ** 2
        self.patch_embed = Conv2D(3, dim, patch_size, patch_size, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.num_patches + 1, dim, device=device)
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, device=device)
            for _ in range(depth)
        )
        self.ln = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, init="trunc_normal", device=device)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ViT":
        """Seeded random weights with the JAX initialisers' distributions."""
        trunc_normal_(self.cls_token.data, generator)
        trunc_normal_(self.pos_embed.data, generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor, use_flash: bool = True) -> torch.Tensor:
        """x: NHWC [B, image_size, image_size, 3] -> logits [B, num_classes]."""
        b = x.shape[0]
        y = self.patch_embed(x).reshape(b, -1, self.dim)       # [B, P, D]
        cls = self.cls_token.to(y.dtype).expand(b, 1, self.dim)
        y = torch.cat([cls, y], dim=1) + self.pos_embed.to(y.dtype)
        for blk in self.blocks:
            y = blk(y, use_flash)
        return self.head(self.ln(y)[:, 0])

    def fold(self) -> "ViT":
        """Inference uses the same parameters: folding is the identity."""
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x, use_flash=True)


def vit_b16(num_classes: int = 1000, image_size: int = 384, device=None) -> ViT:
    return ViT(image_size=image_size, num_classes=num_classes, device=device)


def vit_s16(num_classes: int = 1000, image_size: int = 224, device=None) -> ViT:
    """ViT-S/16: dim 384, 12 layers, 6 heads of d=64."""
    return ViT(image_size=image_size, dim=384, depth=12, num_heads=6,
               num_classes=num_classes, device=device)


def vit_l16(num_classes: int = 1000, image_size: int = 384, device=None) -> ViT:
    return ViT(image_size=image_size, dim=1024, depth=24, num_heads=16,
               num_classes=num_classes, device=device)


def vit_tiny(num_classes: int = 1000, device=None) -> ViT:
    """Dev/CI ViT: 8 blocks of dim 32 at 64 px. Not a zoo model."""
    return ViT(image_size=64, patch_size=8, dim=32, depth=8, num_heads=2,
               num_classes=num_classes, device=device)
