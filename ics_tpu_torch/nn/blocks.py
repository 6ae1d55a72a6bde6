"""Composite blocks (counterpart of ``ics_tpu/nn/blocks.py``): Conv+BN with
inference folding. ``SEBlock`` comes with the depthwise models."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ics_tpu_torch.nn.layers import BatchNorm, Conv2D, fold_batchnorm


class ConvBN(nn.Module):
    """Bias-free convolution and BatchNorm. ``fold()`` turns the BatchNorm
    into an fp32 (scale, bias) pair held as buffers; ``apply_folded`` is the
    serving forward."""

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
