"""Vision Transformer (counterpart of ``ics_tpu/models/vit.py``).

The patch embed is a strided convolution (cuDNN); attention goes through
the hand-written flash kernel (``ics_tpu_torch.ops.attention``) on the
serving path, which reads q, k and v out of the fused qkv product by their
strides, and through its plain version with ``use_flash=False``. The
registered models take the kernel at head_dim 64 (ViT-S/B/L) and at head_dim
128 (``vit_b16_h6d128``, ``vit_l16_h8d128``: the kernel's other ``wgmma``
instantiation). ViT-B/16 @384 has 577 tokens (24x24 patches + cls); the
kernel masks the ragged last tile itself. Training runs the plain version
(the kernel has no backward), or ring attention over a sequence-parallel
mesh (``MultiHeadAttention.ring``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ics_tpu_torch.nn.layers import (
    Conv2D,
    Dense,
    LayerNorm,
    gelu,
    reset_all_parameters,
    run_block,
    trunc_normal_,
)
from ics_tpu_torch.ops.attention import attention_reference, flash_attention_qkv


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
        # the sequence-parallel seam (a FineTuner on an 'sp' mesh): set to
        # (mesh, axis), the training path (use_flash off) rings the tokens
        # over that axis (parallel.ring_attention) in place of plain attention
        self.ring = None

    def forward(self, x: torch.Tensor, use_flash: bool = True) -> torch.Tensor:
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        if self.ring is not None and not use_flash:
            from ics_tpu_torch.parallel.ring_attention import ring_attention_padded

            mesh, axis = self.ring
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # [B, H, S, hd] views
            out = ring_attention_padded(q, k, v, mesh, axis=axis).transpose(1, 2)
        elif use_flash:
            # the kernel reads q, k and v out of the product by their strides
            # and writes [B, S, H, hd]: no copy on either side of it
            out = flash_attention_qkv(qkv)
        else:
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)     # [B, H, S, hd] views
            out = attention_reference(q, k, v).transpose(1, 2)
        return self.proj(out.reshape(b, s, self.dim))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 gelu_exact: bool = True, device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.fc1 = Dense(dim, dim * mlp_ratio, device=device)
        self.fc2 = Dense(dim * mlp_ratio, dim, device=device)
        # GELU's form follows the dtype (erf in fp32, tanh in bf16) unless
        # gelu_exact is False, which takes tanh in every dtype (nn.layers.gelu)
        self.gelu_exact = gelu_exact

    def forward(self, x: torch.Tensor, use_flash: bool = True) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), use_flash)
        y = gelu(self.fc1(self.ln2(x)), exact=self.gelu_exact)
        return x + self.fc2(y)


class ViT(nn.Module):
    def __init__(self, image_size: int = 384, patch_size: int = 16,
                 dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_classes: int = 1000, gelu_exact: bool = True, device=None):
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
            TransformerBlock(dim, num_heads, gelu_exact=gelu_exact, device=device)
            for _ in range(depth)
        )
        self.ln = LayerNorm(dim, device=device)
        self.head = Dense(dim, num_classes, init="trunc_normal", device=device)
        # the flash kernel has no backward: the fine-tuner turns it off, as the
        # reference trains on its plain attention
        self.use_flash = True
        self.remat = False   # per-block rematerialisation in training (run_block)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ViT":
        """Seeded random weights with the JAX initialisers' distributions."""
        trunc_normal_(self.cls_token.data, generator)
        trunc_normal_(self.pos_embed.data, generator)
        return reset_all_parameters(self, generator)

    def forward(self, x: torch.Tensor, use_flash: Optional[bool] = None) -> torch.Tensor:
        """x: NHWC [B, image_size, image_size, 3] -> logits [B, num_classes];
        the attention through the flash kernel unless ``use_flash`` (default:
        the model's ``use_flash``) is False."""
        b = x.shape[0]
        y = self.patch_embed(x).reshape(b, -1, self.dim)       # [B, P, D]
        cls = self.cls_token.to(y.dtype).expand(b, 1, self.dim)
        y = torch.cat([cls, y], dim=1) + self.pos_embed.to(y.dtype)
        use_flash = self.use_flash if use_flash is None else use_flash
        for blk in self.blocks:
            y = run_block(self.remat, blk, y, use_flash)
        return self.head(self.ln(y)[:, 0])

    def fold(self) -> "ViT":
        """Inference uses the same parameters: folding is the identity."""
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x, use_flash=True)


def vit_b16(num_classes: int = 1000, image_size: int = 384, device=None) -> ViT:
    return ViT(image_size=image_size, num_classes=num_classes, device=device)


def vit_b16_h6d128(num_classes: int = 1000, image_size: int = 384, device=None) -> ViT:
    """ViT-B/16 with 6 heads of d=128 in place of 12 of d=64: the same width,
    depth and parameter count, the flash kernel at head_dim 128, and the tanh
    GELU in every dtype. Not weight-compatible with standard ViT-B/16
    checkpoints; meant for fine-tuning from its own weights."""
    return ViT(image_size=image_size, num_classes=num_classes, num_heads=6,
               gelu_exact=False, device=device)


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


def vit_l16_h8d128(num_classes: int = 1000, image_size: int = 384, device=None) -> ViT:
    """ViT-L/16 with 8 heads of d=128 (see ``vit_b16_h6d128``)."""
    return ViT(image_size=image_size, dim=1024, depth=24, num_heads=8,
               num_classes=num_classes, gelu_exact=False, device=device)
