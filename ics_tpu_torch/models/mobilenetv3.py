"""MobileNetV3-Small (counterpart of ``ics_tpu/models/mobilenetv3.py``), NHWC,
inference: the single-image latency configuration (BASELINE cfg 1).

Inverted residuals (expand, depthwise, squeeze-excitation, project) with
hard-swish, per the paper's Small table. The depthwise convolution of every
stride-1 block (7 of the 11) runs in the hand-written kernel on the card
(``ics_tpu_torch.ops.depthwise``, through ``Conv2D``); the stride-2 ones are
cuDNN grouped convolutions, as the JAX package leaves them to XLA. Padding
is the symmetric ``k // 2`` at every stride, BatchNorm eps 1e-3 and the
squeeze width a multiple of 8: the torchvision conventions the JAX model
follows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ics_tpu_torch.nn.blocks import ConvBN, SEBlock, apply_as, fold_convbn
from ics_tpu_torch.nn.layers import (
    Dense,
    global_avg_pool,
    hard_swish,
    relu,
    reset_all_parameters,
)

# kernel, expansion, out_ch, use_se, activation, stride
SMALL_SPEC = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1),
    (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1),
    (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2),
    (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1),
]

_BN_EPS = 1e-3


def _divisible(v: int, divisor: int = 8) -> int:
    new = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new < 0.9 * v:
        new += divisor
    return new


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, kernel: int, exp: int, out_ch: int, use_se: bool,
                 act: str, stride: int, device=None):
        super().__init__()
        self.exp = ConvBN(in_ch, exp, 1, eps=_BN_EPS, device=device) if exp != in_ch else None
        self.dw = ConvBN(exp, exp, kernel, stride, groups=exp, padding=kernel // 2,
                         eps=_BN_EPS, device=device)
        self.se = SEBlock(exp, _divisible(exp // 4), gate="hard", device=device) \
            if use_se else None
        self.proj = ConvBN(exp, out_ch, 1, eps=_BN_EPS, device=device)
        self.act = hard_swish if act == "hs" else relu
        self.use_residual = stride == 1 and in_ch == out_ch

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        y = x
        if self.exp is not None:
            y = self.act(conv(self.exp, y))
        y = self.act(conv(self.dw, y))
        if self.se is not None:
            y = self.se(y)
        y = conv(self.proj, y)
        return y + x if self.use_residual else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class MobileNetV3Small(nn.Module):
    def __init__(self, num_classes: int = 1000, device=None):
        super().__init__()
        self.stem = ConvBN(3, 16, 3, 2, padding=1, eps=_BN_EPS, device=device)
        self.blocks = nn.ModuleList()
        in_ch = 16
        for kernel, exp, out_ch, use_se, act, stride in SMALL_SPEC:
            self.blocks.append(
                InvertedResidual(in_ch, kernel, exp, out_ch, use_se, act, stride, device=device)
            )
            in_ch = out_ch
        self.conv_last = ConvBN(in_ch, 576, 1, eps=_BN_EPS, device=device)
        self.fc1 = Dense(576, 1024, device=device)
        self.head = Dense(1024, num_classes, device=device)
        self.num_classes = num_classes

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "MobileNetV3Small":
        return reset_all_parameters(self, generator)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        y = hard_swish(conv(self.stem, x))
        for blk in self.blocks:
            y = conv(blk, y)
        y = hard_swish(conv(self.conv_last, y))
        y = hard_swish(self.fc1(global_avg_pool(y)))
        return self.head(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes], BatchNorm as a
        layer (running statistics in eval mode)."""
        return self._run(x, folded=False)

    def fold(self) -> "MobileNetV3Small":
        return fold_convbn(self)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


def mobilenetv3_small(num_classes: int = 1000, device=None) -> MobileNetV3Small:
    return MobileNetV3Small(num_classes, device=device)
