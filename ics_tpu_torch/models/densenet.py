"""DenseNet (counterpart of ``ics_tpu/models/densenet.py``), NHWC, inference.

torchvision ``densenet*`` layout: every layer of a dense block takes the
concatenation of the block's input and of every earlier layer's output, and
adds ``growth`` channels; transitions halve the channels (1x1) and the
resolution (2x2 average pool). Every convolution goes to cuDNN in
``channels_last`` memory.

The BatchNorms are pre-activation (BN -> ReLU -> conv), so none folds into
the convolution after it: ``fold`` turns each into an fp32 (scale, shift)
pair held as buffers (``PreActBatchNorm``), applied as the reference's
``_fma``: ``x * scale + shift`` in the activation's dtype. A cast of the
folded model casts the pair with it (bf16 under the engine's bf16 cast), as
the JAX engine casts every fp32 leaf of the folded tree. Only the stem is a
conv followed by its BN and folds into a ``ConvBN``.

The concatenations. Each layer's input is the concatenation of the block's
input and every earlier layer's output, as in the reference
(``jnp.concatenate``, which XLA lays out in place). In eager PyTorch
``torch.cat`` copies the running tensor at every layer, quadratic in the
block's depth. A buffer at the block's final width, each layer's channels
copied into their slice, was measured against it on an H100
(``chip_smoke.py`` [5e], bf16, bucket 32): 4 % less device time and four
more launches a forward, but the step is bound by the host's launches, and
``torch.cat`` was as fast or faster on the wall clock in two of three runs.
So the forward concatenates, folded and unfolded alike, which autograd of
the parameters needs anyway (the buffer's in-place slice writes would
invalidate the slices it saves).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ics_tpu_torch.nn.blocks import ConvBN, apply_as, fold_convbn
from ics_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    avg_pool,
    fold_batchnorm,
    global_avg_pool,
    max_pool,
    relu,
    reset_all_parameters,
)


class PreActBatchNorm(BatchNorm):
    """A BatchNorm that comes before its ReLU and convolution. ``fold()``
    keeps it as an fp32 (scale, shift) pair of buffers; ``apply_folded`` is
    the reference's ``_fma`` (``ics_tpu/models/densenet.py:78``)."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, device=device)
        self.register_buffer("scale", None)
        self.register_buffer("shift", None)

    def fold(self) -> "PreActBatchNorm":
        self.scale, self.shift = fold_batchnorm(self)
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype) + self.shift.to(x.dtype)


class DenseLayer(nn.Module):
    """torchvision ``_DenseLayer``: BN -> ReLU -> 1x1 (``bn_size * growth``)
    -> BN -> ReLU -> 3x3 (``growth``), its output concatenated onto its
    input."""

    def __init__(self, in_ch: int, growth: int = 32, bn_size: int = 4, device=None):
        super().__init__()
        inner = bn_size * growth
        self.bn1 = PreActBatchNorm(in_ch, device=device)
        self.conv1 = Conv2D(in_ch, inner, 1, use_bias=False, device=device)
        self.bn2 = PreActBatchNorm(inner, device=device)
        self.conv2 = Conv2D(inner, growth, 3, padding=1, use_bias=False, device=device)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        bn = apply_as(folded)
        y = self.conv1(relu(bn(self.bn1, x)))
        return torch.cat([x, self.conv2(relu(bn(self.bn2, y)))], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class Transition(nn.Module):
    """torchvision ``_Transition``: BN -> ReLU -> 1x1 (halve the channels) ->
    2x2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.bn = PreActBatchNorm(in_ch, device=device)
        self.conv = Conv2D(in_ch, out_ch, 1, use_bias=False, device=device)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        return avg_pool(self.conv(relu(apply_as(folded)(self.bn, x))), 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=False)

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth: int = 32,
                 init_features: int = 64, num_classes: int = 1000, device=None):
        super().__init__()
        self.block_config = tuple(block_config)
        # the stem is conv then BN: it folds into the conv
        self.stem = ConvBN(3, init_features, 7, 2, padding=3, device=device)
        self.stages = nn.ModuleList()
        self.down = nn.ModuleList()
        ch = init_features
        for i, count in enumerate(block_config):
            layers = nn.ModuleList()
            for _ in range(count):
                layers.append(DenseLayer(ch, growth, device=device))
                ch += growth
            self.stages.append(layers)
            if i < len(block_config) - 1:
                self.down.append(Transition(ch, ch // 2, device=device))
                ch //= 2
        self.final_bn = PreActBatchNorm(ch, device=device)
        self.head = Dense(ch, num_classes, init="kaiming", device=device)
        self.num_classes = num_classes
        self.out_ch = ch

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DenseNet":
        """Seeded random weights with the JAX initialisers' distributions."""
        return reset_all_parameters(self, generator)

    def _run(self, x: torch.Tensor, folded: bool) -> torch.Tensor:
        apply = apply_as(folded)
        y = max_pool(relu(apply(self.stem, x)), 3, 2, 1)
        for i, layers in enumerate(self.stages):
            for layer in layers:
                y = apply(layer, y)
            if i < len(self.down):
                y = apply(self.down[i], y)
        y = relu(apply(self.final_bn, y))
        return self.head(global_avg_pool(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, 3] -> logits [B, num_classes], BatchNorm as a
        layer (running statistics in eval mode)."""
        return self._run(x, folded=False)

    def fold(self) -> "DenseNet":
        """Fold the stem's BN into its conv and every other BN into its
        (scale, shift) pair; store every convolution's weight as cuDNN's
        NHWC kernels take it (OHWI), once."""
        fold_convbn(self)
        for m in self.modules():
            if isinstance(m, PreActBatchNorm):
                m.fold()
            elif isinstance(m, Conv2D):
                m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, folded=True)


def densenet121(num_classes: int = 1000, device=None) -> DenseNet:
    """torchvision-compatible (7,978,856 parameters at 1000 classes)."""
    return DenseNet((6, 12, 24, 16), num_classes=num_classes, device=device)


def densenet169(num_classes: int = 1000, device=None) -> DenseNet:
    """torchvision-compatible (14,149,480 parameters at 1000 classes)."""
    return DenseNet((6, 12, 32, 32), num_classes=num_classes, device=device)


def densenet_micro(num_classes: int = 1000, device=None) -> DenseNet:
    """Two tiny blocks: dev/CI model of the family (pre-activation BN
    folding, concatenation growth, transitions). Not a serving model."""
    return DenseNet((2, 2), growth=8, init_features=16, num_classes=num_classes,
                    device=device)
