"""ResNet v1.5 (counterpart of ``ics_tpu/models/resnet.py``), NHWC, inference.

Every convolution outside a fused chain goes to cuDNN in ``channels_last``
memory (the JAX package leaves those to XLA). ``fold(fused_chains=True)``
packs the stride-1 identity bottlenecks of the early stages for the
hand-written fused kernel (``ics_tpu_torch.ops.bottleneck``), by the same
byte rule as the JAX ``fold(pallas_chains=True)``, so ResNet-50 chains
stages 0 and 1 and nothing else. The space-to-depth stem of the JAX model
is not ported; ``remat`` (training) rematerialises each block
(``nn.layers.run_block``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ics_tpu_torch.nn.blocks import ConvBN, fold_convbn
from ics_tpu_torch.nn.layers import (
    Dense,
    global_avg_pool,
    max_pool,
    relu,
    reset_all_parameters,
    run_block,
)
from ics_tpu_torch.ops.bottleneck import ChainWeights, bottleneck_chain, pack_chain_weights

# The JAX fold chains a stage only if its identity blocks' weights are at
# most this many bytes in bf16 (there: what the kernel maps into fast memory
# at once). The port keeps the rule so both packages chain the same stages.
CHAIN_WEIGHT_BUDGET = 8 * 1024 * 1024


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, device=None):
        super().__init__()
        out_ch = width * self.expansion
        # torchvision convention: ResNeXt (groups) and Wide-ResNet
        # (base_width) reuse this block
        inner = int(width * (base_width / 64.0)) * groups
        self.cbr1 = ConvBN(in_ch, inner, 1, device=device)
        # v1.5: the stride sits on the 3x3, with symmetric padding k // 2
        # (at stride 2 XLA's SAME would pad (1, 2))
        self.cbr2 = ConvBN(inner, inner, 3, stride, padding=1, groups=groups,
                           device=device)
        self.cbr3 = ConvBN(inner, out_ch, 1, device=device)
        if stride != 1 or in_ch != out_ch:
            self.down = ConvBN(in_ch, out_ch, 1, stride, device=device)
        else:
            self.down = None
        self.out_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.cbr1(x))
        y = relu(self.cbr2(y))
        y = self.cbr3(y)
        shortcut = x if self.down is None else self.down(x)
        return relu(y + shortcut)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.cbr1.apply_folded(x))
        y = relu(self.cbr2.apply_folded(y))
        y = self.cbr3.apply_folded(y)
        shortcut = x if self.down is None else self.down.apply_folded(x)
        return relu(y + shortcut)


class BasicBlock(nn.Module):
    """Two-3x3 residual block (ResNet-18/34); the stride sits on the first
    3x3, as in torchvision."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1, device=None):
        super().__init__()
        self.cbr1 = ConvBN(in_ch, width, 3, stride, padding=1, device=device)
        self.cbr2 = ConvBN(width, width, 3, padding=1, device=device)
        if stride != 1 or in_ch != width:
            self.down = ConvBN(in_ch, width, 1, stride, device=device)
        else:
            self.down = None
        self.out_ch = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.cbr1(x))
        y = self.cbr2(y)
        shortcut = x if self.down is None else self.down(x)
        return relu(y + shortcut)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.cbr1.apply_folded(x))
        y = self.cbr2.apply_folded(y)
        shortcut = x if self.down is None else self.down.apply_folded(x)
        return relu(y + shortcut)


class ResNet(nn.Module):
    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, in_ch: int = 3, block_cls=Bottleneck,
                 groups: int = 1, base_width: int = 64, device=None):
        super().__init__()
        self.block_cls = block_cls
        self.groups = groups
        self.base_width = base_width
        if block_cls is BasicBlock and (groups != 1 or base_width != 64):
            raise ValueError(
                "basic blocks only support groups=1, base_width=64 "
                "(torchvision convention)"
            )
        self.stem = ConvBN(in_ch, 64, 7, 2, padding=3, device=device)
        self.stages = nn.ModuleList()
        ch = 64
        for stage_idx, count in enumerate(block_counts):
            width = 64 * (2 ** stage_idx)
            stride = 1 if stage_idx == 0 else 2
            blocks = nn.ModuleList()
            for b in range(count):
                kwargs = {"device": device}
                if block_cls is Bottleneck:
                    kwargs.update(groups=groups, base_width=base_width)
                blocks.append(block_cls(ch, width, stride if b == 0 else 1, **kwargs))
                ch = width * block_cls.expansion
            self.stages.append(blocks)
        self.head = Dense(ch, num_classes, init="kaiming", device=device)
        self.num_classes = num_classes
        # stage index (as a string) -> ChainWeights, filled by fold(fused_chains=True)
        self.chains = nn.ModuleDict()
        self.remat = False   # per-block rematerialisation in training (run_block)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ResNet":
        """Seeded random weights with the JAX initialisers' distributions."""
        return reset_all_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes], BatchNorm as a
        layer (running statistics in eval mode)."""
        y = max_pool(relu(self.stem(x)), 3, 2, 1)
        for blocks in self.stages:
            for blk in blocks:
                y = run_block(self.remat, blk, y)
        return self.head(global_avg_pool(y))

    @property
    def can_fuse_chains(self) -> bool:
        """Whether ``fold(fused_chains=True)`` has a chain path for this
        model: dense bottlenecks at the standard inner width."""
        return self.block_cls is Bottleneck and self.groups == 1 and self.base_width == 64

    def fold(self, fused_chains: bool = False) -> "ResNet":
        """Fold every BatchNorm into (scale, bias) for ``apply_folded``.
        ``fused_chains``: also pack the identity blocks (all but the first)
        of each stage whose weights fit the byte budget, for the fused
        bottleneck-chain kernel. Off by default, as in the JAX package."""
        if fused_chains and self.block_cls is not Bottleneck:
            raise ValueError(
                "fused_chains packs bottleneck (cbr1/2/3) weights; "
                "basic-block ResNets have no fused-chain path"
            )
        if fused_chains and not self.can_fuse_chains:
            raise ValueError(
                "fused_chains assumes dense 3x3 convs; grouped/wide "
                "bottlenecks (ResNeXt/Wide-ResNet) have no fused-chain path"
            )
        fold_convbn(self)
        self.chains = nn.ModuleDict()
        if fused_chains:
            for si, blocks in enumerate(self.stages):
                tail = list(blocks)[1:]
                if not tail:
                    continue
                packed_bytes = 2 * sum(
                    cb.conv.weight.numel()
                    for blk in tail for cb in (blk.cbr1, blk.cbr2, blk.cbr3)
                )
                if packed_bytes <= CHAIN_WEIGHT_BUDGET:
                    self.chains[str(si)] = ChainWeights(pack_chain_weights(tail))
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        y = max_pool(relu(self.stem.apply_folded(x)), 3, 2, 1)
        for si, blocks in enumerate(self.stages):
            if str(si) in self.chains:
                y = blocks[0].apply_folded(y)
                y = bottleneck_chain(y.contiguous(), self.chains[str(si)])
            else:
                for blk in blocks:
                    y = blk.apply_folded(y)
        return self.head(global_avg_pool(y))


def resnet18(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, block_cls=BasicBlock, device=device)


def resnet34(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, block_cls=BasicBlock, device=device)


def resnet50(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, device=device)


def resnet101(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet((3, 4, 23, 3), num_classes, device=device)


def resnet152(num_classes: int = 1000, device=None) -> ResNet:
    return ResNet((3, 8, 36, 3), num_classes, device=device)


def resnet_tiny(num_classes: int = 1000, device=None) -> ResNet:
    """One bottleneck per stage: dev/CI model for the serving stack. Not a
    zoo model."""
    return ResNet((1, 1, 1, 1), num_classes, device=device)


def resnext50_32x4d(num_classes: int = 1000, device=None) -> ResNet:
    """ResNeXt-50 32x4d: 32-group 3x3s at twice the inner width."""
    return ResNet((3, 4, 6, 3), num_classes, groups=32, base_width=4, device=device)


def wide_resnet50_2(num_classes: int = 1000, device=None) -> ResNet:
    """Wide-ResNet-50-2: twice the inner bottleneck width, dense convs."""
    return ResNet((3, 4, 6, 3), num_classes, base_width=128, device=device)
