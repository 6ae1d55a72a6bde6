"""RegNet-Y (counterpart of ``ics_tpu/models/regnet.py``), NHWC, inference.

SE-gated bottlenecks with grouped 3x3 convolutions at a fixed group width
(torchvision ``regnet_y_*`` layout): every stage opens at stride 2, and the
stem is the only stride before them (no max pool). Every convolution goes to
cuDNN in ``channels_last`` memory; the grouped 3x3 has ``groups = w_b //
group_width``, never ``in_ch``, so ``Conv2D`` never sends it to the
depthwise kernel. Every convolution is followed by its BatchNorm, so the
whole family folds to conv + FMA through ``ConvBN``, as ResNet does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ics_tpu_torch.nn.blocks import ConvBN, SEBlock, apply_as, fold_convbn
from ics_tpu_torch.nn.layers import Dense, global_avg_pool, relu, reset_all_parameters


class RegNetBlock(nn.Module):
    """torchvision ``ResBottleneckBlock`` (bottleneck multiplier 1): 1x1 ->
    grouped 3x3 (stride) -> SE (squeeze ``round(0.25 * w_in)``, ReLU,
    sigmoid gate) -> 1x1, residual with a projected shortcut on a change of
    shape."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float = 0.25, device=None):
        super().__init__()
        w_b = w_out   # bottleneck multiplier 1.0 for the whole Y family
        self.a = ConvBN(w_in, w_b, 1, device=device)
        self.b = ConvBN(w_b, w_b, 3, stride, groups=w_b // group_width, padding=1,
                        device=device)
        self.se = SEBlock(w_b, max(1, int(round(se_ratio * w_in))), device=device)
        self.c = ConvBN(w_b, w_out, 1, device=device)
        self.proj = (ConvBN(w_in, w_out, 1, stride, device=device)
                     if (w_in != w_out or stride != 1) else None)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        y = relu(conv(self.a, x))
        y = relu(conv(self.b, y))
        y = conv(self.c, self.se(y))
        shortcut = x if self.proj is None else conv(self.proj, x)
        return relu(y + shortcut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class RegNet(nn.Module):
    STEM_WIDTH = 32

    def __init__(self, depths: Sequence[int], widths: Sequence[int], group_width: int,
                 num_classes: int = 1000, device=None):
        super().__init__()
        self.stem = ConvBN(3, self.STEM_WIDTH, 3, 2, padding=1, device=device)
        self.stages = nn.ModuleList()
        w_in = self.STEM_WIDTH
        for depth, w_out in zip(depths, widths):
            blocks = nn.ModuleList()
            for b in range(depth):
                # every stage opens at stride 2 (torchvision AnyStage)
                blocks.append(RegNetBlock(w_in, w_out, 2 if b == 0 else 1, group_width,
                                          device=device))
                w_in = w_out
            self.stages.append(blocks)
        self.head = Dense(w_in, num_classes, init="kaiming", device=device)
        self.num_classes = num_classes
        self.out_ch = w_in

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "RegNet":
        """Seeded random weights with the JAX initialisers' distributions."""
        return reset_all_parameters(self, generator)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        y = relu(apply_as(folded)(self.stem, x))
        for blocks in self.stages:
            for blk in blocks:
                y = apply_as(folded)(blk, y)
        return self.head(global_avg_pool(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes], BatchNorm as a
        layer (running statistics in eval mode)."""
        return self._run(x, folded=False)

    def fold(self) -> "RegNet":
        return fold_convbn(self)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


def regnet_y_400mf(num_classes: int = 1000, device=None) -> RegNet:
    """torchvision-compatible (4,344,144 parameters at 1000 classes)."""
    return RegNet((1, 3, 6, 6), (48, 104, 208, 440), 8, num_classes, device=device)


def regnet_y_1_6gf(num_classes: int = 1000, device=None) -> RegNet:
    """torchvision-compatible (11,202,430 parameters at 1000 classes)."""
    return RegNet((2, 6, 17, 2), (48, 120, 336, 888), 24, num_classes, device=device)


def regnet_micro(num_classes: int = 1000, device=None) -> RegNet:
    """Two tiny stages: dev/CI model of the family (SE-gated grouped
    bottlenecks, stride-2 stage openings). Not a serving model."""
    return RegNet((1, 1), (16, 32), 8, num_classes, device=device)
