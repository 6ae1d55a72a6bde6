"""ConvNeXt (counterpart of ``ics_tpu/models/convnext.py``), NHWC, inference.

A block is a 7x7 depthwise convolution, LayerNorm, and two pointwise
products (C -> 4C -> C, cuBLAS) with a GELU between and a layer scale
after. The depthwise convolution, bias included, runs in the hand-written
kernel on the card (``ics_tpu_torch.ops.depthwise``, through ``Conv2D``):
18 launches a forward for ConvNeXt-Tiny. The strided stem and downsampling
convolutions go to cuDNN. There is no BatchNorm, so folding is the
identity. ``remat`` (training) rematerialises each block
(``nn.layers.run_block``), as the JAX model's flag does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ics_tpu_torch.nn.layers import Conv2D, Dense, LayerNorm, gelu, reset_all_parameters, run_block


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6, device=None):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2D(dim, dim, 7, 1, padding="SAME", groups=dim,
                             use_bias=True, device=device)
        self.ln = LayerNorm(dim, device=device)
        self.fc1 = Dense(dim, 4 * dim, device=device)
        self.fc2 = Dense(4 * dim, dim, device=device)
        # the layer scale: fp32 in the tree, cast to the activation's dtype
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln(self.dwconv(x))
        y = self.fc2(gelu(self.fc1(y)))
        return x + y * self.gamma.to(y.dtype)


class Downsample(nn.Module):
    """LayerNorm, then a 2x2 stride-2 convolution to the next stage's width."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.ln = LayerNorm(in_dim, device=device)
        self.conv = Conv2D(in_dim, out_dim, 2, 2, use_bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.ln(x))


class ConvNeXt(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, device=None):
        super().__init__()
        self.remat = False   # per-block rematerialisation in training (run_block)
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.num_classes = num_classes
        self.stem = Conv2D(3, dims[0], 4, 4, use_bias=True, device=device)
        self.stem_ln = LayerNorm(dims[0], device=device)
        self.down = nn.ModuleList(
            Downsample(dims[i], dims[i + 1], device=device) for i in range(3)
        )
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dims[i], device=device) for _ in range(depths[i]))
            for i in range(4)
        )
        self.final_ln = LayerNorm(dims[-1], device=device)
        self.head = Dense(dims[-1], num_classes, init="trunc_normal", device=device)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ConvNeXt":
        """Seeded random weights with the JAX initialisers' distributions."""
        for module in self.modules():
            if isinstance(module, ConvNeXtBlock):
                nn.init.constant_(module.gamma, module.layer_scale_init)
        return reset_all_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes]."""
        y = self.stem_ln(self.stem(x))
        for i, blocks in enumerate(self.stages):
            if i > 0:
                y = self.down[i - 1](y)
            for blk in blocks:
                y = run_block(self.remat, blk, y)
        return self.head(self.final_ln(y.mean(dim=(1, 2))))

    def fold(self) -> "ConvNeXt":
        """LayerNorm has no running statistics: folding is the identity."""
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x)


def convnext_tiny(num_classes: int = 1000, device=None) -> ConvNeXt:
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768), num_classes, device=device)


def convnext_small(num_classes: int = 1000, device=None) -> ConvNeXt:
    return ConvNeXt((3, 3, 27, 3), (96, 192, 384, 768), num_classes, device=device)
