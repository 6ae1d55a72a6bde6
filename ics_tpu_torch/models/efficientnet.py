"""EfficientNet B0/B4 and EfficientNetV2-S/M (counterpart of
``ics_tpu/models/efficientnet.py``), NHWC, inference. B4 is the
mixed-resolution configuration (BASELINE cfg 4).

``MBConv``: expand 1x1, depthwise, squeeze-excitation, project 1x1, SiLU.
The depthwise convolution of every stride-1 ``MBConv`` runs in the
hand-written kernel on the card (``ics_tpu_torch.ops.depthwise``, through
``Conv2D``); the stride-2 ones are cuDNN grouped convolutions, as the JAX
package leaves them to XLA. ``FusedMBConv`` (V2's early stages) is a dense
3x3 and has no depthwise part. Padding is the symmetric ``k // 2`` at every
stride; BatchNorm eps is 1e-5 for V1 and 1e-3 for V2; the squeeze width is
``max(1, in_ch // 4)``: the torchvision conventions the JAX model follows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ics_tpu_torch.nn.blocks import ConvBN, SEBlock, apply_as, fold_convbn
from ics_tpu_torch.nn.layers import Dense, global_avg_pool, reset_all_parameters, silu

# EfficientNet-B0 base: expand, out_ch, kernel, stride, repeats
BASE_SPEC = [
    (1, 16, 3, 1, 1),
    (6, 24, 3, 2, 2),
    (6, 40, 5, 2, 2),
    (6, 80, 3, 2, 3),
    (6, 112, 5, 1, 3),
    (6, 192, 5, 2, 4),
    (6, 320, 3, 1, 1),
]

# block kind, expand, out_ch, kernel, stride, repeats (torchvision efficientnet_v2_s)
V2_S_SPEC = [
    ("fused", 1, 24, 3, 1, 2),
    ("fused", 4, 48, 3, 2, 4),
    ("fused", 4, 64, 3, 2, 4),
    ("mb", 4, 128, 3, 2, 6),
    ("mb", 6, 160, 3, 1, 9),
    ("mb", 6, 256, 3, 2, 15),
]

# torchvision efficientnet_v2_m: the same stage grammar, one more stage
V2_M_SPEC = [
    ("fused", 1, 24, 3, 1, 3),
    ("fused", 4, 48, 3, 2, 5),
    ("fused", 4, 80, 3, 2, 5),
    ("mb", 4, 160, 3, 2, 7),
    ("mb", 6, 176, 3, 1, 14),
    ("mb", 6, 304, 3, 2, 18),
    ("mb", 6, 512, 3, 1, 5),
]

_V2_BN_EPS = 1e-3


def round_filters(filters: float, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int,
                 bn_eps: float = 1e-5, device=None):
        super().__init__()
        mid = in_ch * expand
        self.exp = ConvBN(in_ch, mid, 1, eps=bn_eps, device=device) if expand != 1 else None
        self.dw = ConvBN(mid, mid, kernel, stride, groups=mid, padding=kernel // 2,
                         eps=bn_eps, device=device)
        self.se = SEBlock(mid, max(1, in_ch // 4), gate="sigmoid", device=device)
        self.proj = ConvBN(mid, out_ch, 1, eps=bn_eps, device=device)
        self.use_residual = stride == 1 and in_ch == out_ch

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        y = x
        if self.exp is not None:
            y = silu(conv(self.exp, y))
        y = self.se(silu(conv(self.dw, y)))
        y = conv(self.proj, y)
        return y + x if self.use_residual else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class FusedMBConv(nn.Module):
    """Fused MBConv: one dense k x k convolution expands and filters; with an
    expansion a 1x1 projection without activation follows."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int,
                 bn_eps: float = 1e-5, device=None):
        super().__init__()
        mid = in_ch * expand
        if expand != 1:
            self.exp = ConvBN(in_ch, mid, kernel, stride, padding=kernel // 2, eps=bn_eps,
                              device=device)
            self.proj = ConvBN(mid, out_ch, 1, eps=bn_eps, device=device)
        else:
            self.exp = None
            self.proj = ConvBN(in_ch, out_ch, kernel, stride, padding=kernel // 2,
                               eps=bn_eps, device=device)
        self.use_residual = stride == 1 and in_ch == out_ch

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        if self.exp is not None:
            y = conv(self.proj, silu(conv(self.exp, x)))
        else:
            y = silu(conv(self.proj, x))
        return y + x if self.use_residual else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class EfficientNet(nn.Module):
    """Stem, a list of blocks, a 1x1 head convolution, pooling and the
    classifier. ``blocks`` is given by the subclass's constructor;
    ``stage_repeats`` says how many of them each stage of the spec holds
    (torchvision's ``features.{stage}.{repeat}``, which the pretrained import
    walks)."""

    def __init__(self, stem_ch: int, blocks: list, head_in: int, head_ch: int,
                 num_classes: int, bn_eps: float, stage_repeats: tuple = (), device=None):
        super().__init__()
        self.stem = ConvBN(3, stem_ch, 3, 2, padding=1, eps=bn_eps, device=device)
        self.blocks = nn.ModuleList(blocks)
        self.stage_repeats = tuple(stage_repeats)
        self.conv_head = ConvBN(head_in, head_ch, 1, eps=bn_eps, device=device)
        self.head = Dense(head_ch, num_classes, device=device)
        self.num_classes = num_classes

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "EfficientNet":
        return reset_all_parameters(self, generator)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        conv = apply_as(folded)
        y = silu(conv(self.stem, x))
        for blk in self.blocks:
            y = conv(blk, y)
        y = silu(conv(self.conv_head, y))
        return self.head(global_avg_pool(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes], BatchNorm as a
        layer (running statistics in eval mode)."""
        return self._run(x, folded=False)

    def fold(self) -> "EfficientNet":
        return fold_convbn(self)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


def efficientnet_v1(width_mult: float, depth_mult: float, num_classes: int = 1000,
                    device=None) -> EfficientNet:
    """The compound-scaled MBConv stack of EfficientNet B0-B7."""
    stem_ch = round_filters(32, width_mult)
    blocks = []
    in_ch = stem_ch
    for expand, out_base, kernel, stride, repeats in BASE_SPEC:
        out_ch = round_filters(out_base, width_mult)
        for r in range(round_repeats(repeats, depth_mult)):
            blocks.append(MBConv(in_ch, out_ch, kernel, stride if r == 0 else 1, expand,
                                 device=device))
            in_ch = out_ch
    return EfficientNet(stem_ch, blocks, in_ch, round_filters(1280, width_mult),
                        num_classes, bn_eps=1e-5,
                        stage_repeats=tuple(round_repeats(spec[-1], depth_mult)
                                            for spec in BASE_SPEC),
                        device=device)


def efficientnet_v2(spec=None, stem_ch: int = 24, head_ch: int = 1280,
                    num_classes: int = 1000, device=None) -> EfficientNet:
    """EfficientNetV2: ``FusedMBConv`` early stages, ``MBConv`` after."""
    blocks = []
    in_ch = stem_ch
    spec = spec or V2_S_SPEC
    for kind, expand, out_ch, kernel, stride, repeats in spec:
        block_cls = FusedMBConv if kind == "fused" else MBConv
        for r in range(repeats):
            blocks.append(block_cls(in_ch, out_ch, kernel, stride if r == 0 else 1, expand,
                                    bn_eps=_V2_BN_EPS, device=device))
            in_ch = out_ch
    return EfficientNet(stem_ch, blocks, in_ch, head_ch, num_classes, bn_eps=_V2_BN_EPS,
                        stage_repeats=tuple(s[-1] for s in spec), device=device)


def efficientnet_b0(num_classes: int = 1000, device=None) -> EfficientNet:
    return efficientnet_v1(1.0, 1.0, num_classes, device=device)


def efficientnet_b4(num_classes: int = 1000, device=None) -> EfficientNet:
    return efficientnet_v1(1.4, 1.8, num_classes, device=device)


def efficientnet_v2_s(num_classes: int = 1000, device=None) -> EfficientNet:
    return efficientnet_v2(num_classes=num_classes, device=device)


def efficientnet_v2_m(num_classes: int = 1000, device=None) -> EfficientNet:
    return efficientnet_v2(spec=V2_M_SPEC, num_classes=num_classes, device=device)
