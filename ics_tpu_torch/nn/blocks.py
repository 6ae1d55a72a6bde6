"""Composite blocks (counterpart of ``ics_tpu/nn/blocks.py``): Conv+BN with
inference folding, and squeeze-excitation."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ics_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    fold_batchnorm,
    hard_sigmoid,
    relu,
)


class ConvBN(nn.Module):
    """Bias-free convolution and BatchNorm. ``fold()`` turns the BatchNorm
    into an fp32 (scale, bias) pair held as buffers; ``apply_folded`` is the
    serving forward. A depthwise convolution (see ``Conv2D``) runs in the
    hand-written kernel on the card, bias-free; scale and bias stay PyTorch
    ops, so the rounding points are the same with and without the kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, padding: Union[int, str] = "SAME",
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride, padding=padding,
                           groups=groups, use_bias=False, device=device)
        self.bn = BatchNorm(out_ch, eps=eps, device=device)
        self.register_buffer("scale", None)
        self.register_buffer("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))

    def fold(self) -> "ConvBN":
        self.scale, self.bias = fold_batchnorm(self.bn)
        return self

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused contract of the JAX package (``blocks.py:45``): the
        convolution's output is rounded to the serving dtype, then scale
        and bias are applied in that dtype."""
        y = self.conv(x)
        return y * self.scale.to(y.dtype) + self.bias.to(y.dtype)


def apply_as(folded: bool):
    """How a ``ConvBN``, or a block made of them, is applied: ``apply_folded``
    (serving) or as layers. The models write each forward once with it."""
    return (lambda m, x: m.apply_folded(x)) if folded else (lambda m, x: m(x))


def fold_convbn(model: nn.Module) -> nn.Module:
    """Fold every ``ConvBN`` of ``model`` and store the weights as cuDNN's NHWC
    kernels take them (OHWI), once."""
    for module in model.modules():
        if isinstance(module, ConvBN):
            module.fold()
            w = module.conv.weight
            w.data = w.data.contiguous(memory_format=torch.channels_last)
    return model


class SEBlock(nn.Module):
    """Squeeze-excitation: mean over H and W, Dense, ReLU, Dense, gate
    (``"hard"``: hard-sigmoid, MobileNetV3; ``"sigmoid"``: EfficientNet)."""

    def __init__(self, channels: int, reduced: int, gate: str = "sigmoid",
                 device=None):
        super().__init__()
        self.fc1 = Dense(channels, reduced, device=device)
        self.fc2 = Dense(reduced, channels, device=device)
        self.gate = gate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc2(relu(self.fc1(x.mean(dim=(1, 2)))))
        y = hard_sigmoid(y) if self.gate == "hard" else torch.sigmoid(y)
        return x * y[:, None, None, :]
