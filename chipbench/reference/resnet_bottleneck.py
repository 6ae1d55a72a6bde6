"""A bottleneck ResNet v1.5 (the stride of each downsampling bottleneck on
its 3x3, as torchvision's), BatchNorm eps 1e-5. Configuration keys:
``stem_width``, ``blocks``, ``widths``, ``expansion``, ``image_size``,
``num_classes``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chipbench.reference.models import Quant, Spec, conv, conv_out, q


def _conv_bn(prefix: str, cin: int, cout: int, k: int, kind: str = "conv",
             scale: str = "bn_weight") -> Spec:
    return [
        (f"{prefix}.conv.weight", (cout, cin, k, k), kind, cin * k * k),
        (f"{prefix}.bn.weight", (cout,), scale, 0),
        (f"{prefix}.bn.bias", (cout,), "bn_bias", 0),
        (f"{prefix}.bn.running_mean", (cout,), "zero", 0),
        (f"{prefix}.bn.running_var", (cout,), "one", 0),
    ]


def param_spec(cfg: dict) -> Spec:
    spec = _conv_bn("stem", 3, cfg["stem_width"], 7, kind="stem")
    ch = cfg["stem_width"]
    for s, (blocks, width) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        out = width * cfg["expansion"]
        for b in range(blocks):
            p = f"stages.{s}.{b}"
            spec += _conv_bn(f"{p}.cbr1", ch, width, 1)
            spec += _conv_bn(f"{p}.cbr2", width, width, 3)
            spec += _conv_bn(f"{p}.cbr3", width, out, 1, scale="bn_weight_branch")
            if b == 0:
                spec += _conv_bn(f"{p}.down", ch, out, 1)
            ch = out
    spec += [("head.weight", (cfg["num_classes"], ch), "head", ch),
             ("head.bias", (cfg["num_classes"],), "zero", 0)]
    return spec


def _bn(sd: dict, prefix: str, x: torch.Tensor, calibrate: bool, eps: float = 1e-5):
    """BatchNorm at the running statistics; ``calibrate`` first sets them from
    this batch (a data-dependent start): each channel's mean, and the
    layer's mean variance for every channel, so a channel that hardly
    varies is not scaled up past the others."""
    if calibrate:
        sd[f"{prefix}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        sd[f"{prefix}.running_var"].fill_(float(x.var(dim=(0, 2, 3), unbiased=False).mean()))
    mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    scale = sd[f"{prefix}.weight"] * torch.rsqrt(var + eps)
    shift = sd[f"{prefix}.bias"] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def features(cfg: dict, sd: dict, x: torch.Tensor, calibrate: bool = False,
             quant: Quant = None) -> torch.Tensor:
    """x [B, 3, H, W] normalised -> pooled features [B, C]."""
    def cbn(prefix, y, stride, pad):
        return q(quant, _bn(sd, f"{prefix}.bn",
                            conv(y, sd[f"{prefix}.conv.weight"], stride, pad, quant), calibrate))

    y = F.max_pool2d(F.relu(cbn("stem", x, 2, 3)), 3, 2, 1)
    for s, blocks in enumerate(cfg["blocks"]):
        for b in range(blocks):
            p = f"stages.{s}.{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            z = F.relu(cbn(f"{p}.cbr1", y, 1, 0))
            z = F.relu(cbn(f"{p}.cbr2", z, stride, 1))
            z = cbn(f"{p}.cbr3", z, 1, 0)
            short = cbn(f"{p}.down", y, stride, 0) if b == 0 else y
            y = q(quant, F.relu(z + short))
    return y.mean(dim=(2, 3))


def macs(cfg: dict) -> int:
    """Multiply-accumulates of one image: convolutions and the head;
    BatchNorm, ReLU and pooling are not counted."""
    size = cfg["image_size"]
    total = 0
    s = conv_out(size, 7, 2, 3)
    total += s * s * 7 * 7 * 3 * cfg["stem_width"]
    s = conv_out(s, 3, 2, 1)                                # max pool
    ch = cfg["stem_width"]
    for stage, (blocks, width) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        out_ch = width * cfg["expansion"]
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            so = conv_out(s, 3, stride, 1)
            total += s * s * ch * width                     # 1x1 at the input size
            total += so * so * 9 * width * width            # 3x3, strided
            total += so * so * width * out_ch               # 1x1
            if b == 0:
                total += so * so * ch * out_ch              # projection shortcut
            s, ch = so, out_ch
    return total + ch * cfg["num_classes"]
