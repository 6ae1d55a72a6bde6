"""The layers ViT needs, as PyTorch modules (counterpart of ``ics_tpu/nn/layers.py``).

Activations stay NHWC at the public functions, as in the JAX package, so
the tests compare like with like. Parameters use PyTorch's layouts (conv
OIHW, linear [out, in]); ``ics_tpu_torch.weights`` maps the JAX layouts
(HWIO, [in, out]) onto them. ``reset_parameters(generator)`` draws the same
distributions as the JAX initialisers, from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator],
                  std: float = 0.02) -> torch.Tensor:
    """JAX's ``truncated_normal``: a unit normal cut at +-2, times ``std``."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Conv2D(nn.Module):
    """Strided VALID convolution with bias on NHWC input, weight OIHW (the
    ViT patch embed). cuDNN computes it: the JAX package left its
    convolutions to XLA, outside Pallas."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight[0].numel()
        nn.init.normal_(self.weight, std=math.sqrt(2.0 / fan_in), generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), self.stride)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, init: str = "xavier", device=None):
        super().__init__()
        self.init_kind = init
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.init_kind == "trunc_normal":
            trunc_normal_(self.weight, generator)
        else:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and affine, cast back to the input
    dtype (``ics_tpu/nn/layers.py:181-187``)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU whose exactness follows the dtype, as in the JAX package: erf
    under fp32, the tanh approximation under bf16/fp16, where its error is
    below rounding."""
    approximate = x.dtype in (torch.bfloat16, torch.float16)
    return F.gelu(x, approximate="tanh" if approximate else "none")
