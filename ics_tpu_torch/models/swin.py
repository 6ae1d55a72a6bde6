"""Swin Transformer v1 (counterpart of ``ics_tpu/models/swin.py``), inference.

A block's attention runs on the qkv product of the whole [B, G, G, C]
image: the qkv and proj GEMMs are per token, so they commute with the
cyclic shift and the window partition and merge. Between the two GEMMs one
hand-written kernel on the card (``ops.window_attention.window_attention_qkv``)
reads q, k and v of each window where they lie, through the shift, and
writes the merged heads back in image order: 12 launches a forward for
Swin-T, and no roll, partition, merge or q/k/v copy. Its plain version is
the chain of PyTorch ops that it replaces (roll, partition, split, scale,
attention, merge, roll), which is what the CPU runs. The shift mask and the
relative-position index are built with numpy at construction, per block,
and held as buffers that are not part of the state dict.

Scores are fp32 in the kernel and in its plain version, which is what the
JAX package's training forward computes; its serving forward keeps the
materialised score tensor in bf16, a memory-traffic workaround this port
has no use for, because the score tensor never reaches device memory here.
``remat`` (training) rematerialises each block (``nn.layers.run_block``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
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
from ics_tpu_torch.ops.window_attention import (
    relative_bias,
    window_attention_qkv,
    window_attention_qkv_reference,
)


def _relative_position_index(window: int) -> np.ndarray:
    """[ww, ww] index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ).reshape(2, -1)                                   # [2, ww]
    rel = coords[:, :, None] - coords[:, None, :]      # [2, ww, ww]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(grid: int, window: int, shift: int) -> np.ndarray:
    """[nW, ww, ww] additive mask (0 / -1e4) separating tokens that were
    not neighbours before the cyclic shift (Swin v1 SW-MSA mask)."""
    img = np.zeros((grid, grid), np.int32)
    cnt = 0
    bounds = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in bounds:
        for ws in bounds:
            img[hs, ws] = cnt
            cnt += 1
    n = grid // window
    wins = img.reshape(n, window, n, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)           # [nW, ww]
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff == 0, 0.0, -1e4).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} does not split into {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.window = window
        self.qkv = Dense(dim, dim * 3, device=device)
        self.proj = Dense(dim, dim, device=device)
        # timm: a trunc-normal(0.02) table [(2w-1)^2, heads]
        self.rel_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads, device=device))
        index = torch.from_numpy(_relative_position_index(window))
        self.register_buffer("rel_index", index.to(device), persistent=False)
        # the kernel's copy of the index (values below 169 at w 7)
        self.register_buffer("rel_index16", index.to(device=device, dtype=torch.int16),
                             persistent=False)
        self._table: Optional[tuple] = None    # (key, fp32 table)
        self.use_kernel = True

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        trunc_normal_(self.rel_bias.data, generator)
        self._table = None   # a write through .data leaves the parameter's version as it was

    def _apply(self, fn, *args, **kwargs):
        self._table = None   # a move or a cast: the fp32 table is made anew
        return super()._apply(fn, *args, **kwargs)

    def bias(self) -> torch.Tensor:
        """The relative-position bias [H, ww, ww] in fp32."""
        return relative_bias(self.rel_bias, self.rel_index)

    def table(self) -> torch.Tensor:
        """The relative-position table [(2w-1)^2, H] in fp32, as the kernel
        gathers it. The parameter itself where it is fp32, so that a gradient
        asked of it is not cut off (the entry then sees it, and the card's
        kernel refuses it); in a cast model, which serves, an fp32 copy, kept
        until the parameter is replaced or written in place."""
        t = self.rel_bias
        if t.dtype == torch.float32:
            return t
        key = (t.data_ptr(), 0 if t.is_inference() else t._version)
        if self._table is None or self._table[0] != key:
            with torch.no_grad():
                self._table = (key, t.detach().float())
        return self._table[1]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shift: int = 0) -> torch.Tensor:
        """x [B, G, G, C] (the whole image); mask [nW, ww, ww] additive,
        fp32, or None; ``shift`` the block's cyclic shift -> [B, G, G, C]."""
        b, g, _, _ = x.shape
        qkv = self.qkv(x).view(b, g, g, 3, self.num_heads, self.head_dim)
        attend = window_attention_qkv if self.use_kernel else window_attention_qkv_reference
        return self.proj(attend(qkv, self.table(), self.rel_index16, mask, self.window, shift,
                                self.head_dim ** -0.5))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, grid: int,
                 mlp_ratio: int = 4, gelu_exact: bool = True, device=None):
        super().__init__()
        if grid % window:
            raise ValueError(f"grid {grid} is not a multiple of the window {window}")
        self.window = window
        self.shift = shift
        self.grid = grid
        self.gelu_exact = gelu_exact
        self.ln1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, num_heads, window, device=device)
        self.ln2 = LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = Dense(dim, dim * mlp_ratio, device=device)
        self.fc2 = Dense(dim * mlp_ratio, dim, device=device)
        # the shift mask as a boolean buffer (True where it cuts), so that a
        # cast of the model cannot round its -1e4; the fp32 mask is made from
        # it once per device
        cut = torch.from_numpy(_shift_attn_mask(grid, window, shift) != 0).to(device) \
            if shift > 0 else None
        self.register_buffer("cut", cut, persistent=False)
        self._mask: Optional[torch.Tensor] = None

    def mask(self) -> Optional[torch.Tensor]:
        """The additive shift mask [nW, ww, ww] in fp32 (0 / -1e4), or None."""
        if self.cut is None:
            return None
        if self._mask is None or self._mask.device != self.cut.device:
            self._mask = torch.where(self.cut, -1e4, 0.0).to(torch.float32)
        return self._mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> the same shape."""
        x = x + self.attn(self.ln1(x), self.mask(), self.shift)
        y = self.fc2(gelu(self.fc1(self.ln2(x)), exact=self.gelu_exact))
        return x + y


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat (4C), LayerNorm, Linear 4C -> 2C without bias."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # timm's quadrant order: (0,0), (1,0), (0,1), (1,1)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 num_classes: int = 1000, gelu_exact: bool = True, device=None):
        super().__init__()
        self.image_size = image_size
        self.num_classes = num_classes
        self.patch_embed = Conv2D(3, embed_dim, patch_size, patch_size, use_bias=True,
                                  device=device)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5, device=device)
        grid = image_size // patch_size
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        dim = embed_dim
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.stages.append(nn.ModuleList(
                SwinBlock(
                    dim, heads, window,
                    # W-MSA and SW-MSA in turns; where the whole grid fits one
                    # window the shift is pointless (timm does the same)
                    shift=0 if (i % 2 == 0 or grid <= window) else window // 2,
                    grid=grid, gelu_exact=gelu_exact, device=device,
                )
                for i in range(depth)
            ))
            if si < len(depths) - 1:
                self.merges.append(PatchMerging(dim, device=device))
                dim *= 2
                grid //= 2
        self.ln = LayerNorm(dim, eps=1e-5, device=device)
        self.head = Dense(dim, num_classes, init="trunc_normal", device=device)
        self.remat = False   # per-block rematerialisation in training (run_block)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SwinTransformer":
        """Seeded random weights with the JAX initialisers' distributions."""
        return reset_all_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, image_size, image_size, 3] -> logits [B, num_classes]."""
        y = self.patch_norm(self.patch_embed(x))               # [B, g, g, C]
        for si, blocks in enumerate(self.stages):
            for blk in blocks:
                y = run_block(self.remat, blk, y)
            if si < len(self.merges):
                y = self.merges[si](y)
        return self.head(self.ln(y).mean(dim=(1, 2)))

    def fold(self) -> "SwinTransformer":
        """Inference uses the same parameters: folding is the identity."""
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x)


def swin_tiny(num_classes: int = 1000, image_size: int = 224, device=None) -> SwinTransformer:
    """Swin-T (timm ``swin_tiny_patch4_window7_224``): depths (2, 2, 6, 2),
    windows of 7 on 56/28/14/7 grids."""
    return SwinTransformer(image_size=image_size, num_classes=num_classes, device=device)


def swin_small(num_classes: int = 1000, image_size: int = 224, device=None) -> SwinTransformer:
    """Swin-S: depths (2, 2, 18, 2), the widths of Swin-T."""
    return SwinTransformer(image_size=image_size, num_classes=num_classes,
                           depths=(2, 2, 18, 2), device=device)


def swin_base(num_classes: int = 1000, image_size: int = 224, device=None) -> SwinTransformer:
    """Swin-B (timm ``swin_base_patch4_window7_224``): embed 128, heads
    (4, 8, 16, 32), the depths of Swin-S."""
    return SwinTransformer(image_size=image_size, num_classes=num_classes, embed_dim=128,
                           depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), device=device)


def swin_micro(num_classes: int = 1000, device=None) -> SwinTransformer:
    """Two short stages at 64 px, window 4: dev/CI model. Not a zoo model."""
    return SwinTransformer(image_size=64, patch_size=4, embed_dim=32, depths=(1, 2),
                           num_heads=(2, 4), window=4, num_classes=num_classes,
                           device=device)
