"""The plain reference of each configuration: its parameters, named as the
state dict the benchmark hands to both sides, its forward pass in plain
PyTorch on NCHW tensors, written from the published architecture, and its
multiply-accumulates an image.

Each architecture is a module of its own, ``reference/<architecture>.py``,
found by the configuration's ``architecture`` key; it gives
``param_spec(cfg)``, ``features(cfg, sd, x, calibrate, quant)`` and
``macs(cfg)``. This module holds what they share. Nothing here imports the
program. ``forward`` computes in float32 with TF32 off; ``quant`` (the
control) rounds both operands of every convolution and matrix product, and
the residual stream after each block or branch, to a lower precision: where
the program holds a tensor in its serving precision, the control holds it
in the one below.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Callable, Optional

import torch
import torch.nn.functional as F

# (name, shape, kind, fan_in); kind picks the distribution the weights are
# drawn from (``chipbench.weights``)
Spec = list[tuple[str, tuple, str, int]]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def architecture(cfg: dict) -> ModuleType:
    """The module ``reference/<cfg["architecture"]>.py``."""
    return importlib.import_module(f"chipbench.reference.{cfg['architecture']}")


def param_spec(cfg: dict) -> Spec:
    return architecture(cfg).param_spec(cfg)


def features(cfg: dict, sd: dict, x: torch.Tensor, calibrate: bool = False,
             quant: Quant = None) -> torch.Tensor:
    return architecture(cfg).features(cfg, sd, x, calibrate=calibrate, quant=quant)


def macs(cfg: dict) -> int:
    return architecture(cfg).macs(cfg)


def logits(cfg: dict, sd: dict, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    return linear(features(cfg, sd, x, quant=quant), sd["head.weight"], sd["head.bias"], quant)


def q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


def conv(x, w, stride, pad, quant, bias=None):
    return F.conv2d(q(quant, x), q(quant, w), bias, stride, pad)


def linear(x, w, b, quant):
    return q(quant, x) @ q(quant, w).t() + b


def conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: float8 e4m3 with one scale a tensor (its
    largest magnitude at e4m3's largest finite value), back to float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
