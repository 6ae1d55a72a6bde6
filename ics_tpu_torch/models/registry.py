"""Registry of the ported models: name -> (constructor, preprocessing config).

Counterpart of ``ics_tpu/models/registry.py`` with its own ``ModelSpec``
and the JAX package's preprocessing sizes and descriptions: every model of
the reference but the two TPU-only ``*_h?d128`` ViTs. ``build(num_classes=..., device=...)`` returns a module with
uninitialised parameters; the engine fills them from a seed or from a
state dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ics_tpu_torch.models import (
    convnext,
    densenet,
    efficientnet,
    mobilenetv3,
    regnet,
    resnet,
    swin,
    vit,
)


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., Any]
    image_size: int
    resize_short: int
    description: str = ""
    # dev/CI-only models (resnet_tiny, vit_tiny, swin_micro): resolvable by name
    # everywhere (tests, TPU_DEFAULT_MODEL overrides) but excluded from the
    # public API surface: a production client must not be able to classify
    # against randomly initialised toy weights
    dev_only: bool = False


_REGISTRY: dict[str, ModelSpec] = {
    spec.name: spec
    for spec in (
        ModelSpec("resnet50", resnet.resnet50, 224, 256,
                  "ResNet-50 v1.5 — the default model; cuDNN convs, optional "
                  "hand-written fused bottleneck chains (BASELINE cfg 2)"),
        ModelSpec("resnet101", resnet.resnet101, 224, 256, "ResNet-101 v1.5"),
        ModelSpec("resnet152", resnet.resnet152, 224, 256, "ResNet-152 v1.5"),
        ModelSpec("resnet18", resnet.resnet18, 224, 256,
                  "ResNet-18 — basic-block light variant (torchvision-compatible)"),
        ModelSpec("resnet34", resnet.resnet34, 224, 256,
                  "ResNet-34 — basic-block variant (torchvision-compatible)"),
        ModelSpec("resnext50_32x4d", resnet.resnext50_32x4d, 224, 256,
                  "ResNeXt-50 32x4d — grouped 3x3s at 2x inner width "
                  "(torchvision-checkpoint-compatible)"),
        ModelSpec("wide_resnet50_2", resnet.wide_resnet50_2, 224, 256,
                  "Wide-ResNet-50-2 — 2x inner bottleneck width, dense convs "
                  "(torchvision-checkpoint-compatible)"),
        ModelSpec("resnet_tiny", resnet.resnet_tiny, 64, 64,
                  "ResNet tiny (1 block/stage @64px) — dev/CI serving-stack model",
                  dev_only=True),
        ModelSpec("vit_b16", vit.vit_b16, 384, 384,
                  "ViT-B/16 @384px — hand-written CUDA flash attention "
                  "(BASELINE cfg 3)"),
        ModelSpec("vit_l16", vit.vit_l16, 384, 384,
                  "ViT-L/16 @384px — large variant, same attention kernel"),
        ModelSpec("vit_s16", vit.vit_s16, 224, 256,
                  "ViT-S/16 @224px — small-dataset fine-tune pick"),
        ModelSpec("vit_tiny", vit.vit_tiny, 64, 64,
                  "ViT tiny (8 blocks @64px) — dev/CI model; not a zoo model",
                  dev_only=True),
        ModelSpec("convnext_tiny", convnext.convnext_tiny, 224, 256,
                  "ConvNeXt-Tiny — LayerNorm, 7x7 depthwise in the hand-written "
                  "CUDA kernel, cuBLAS pointwise products"),
        ModelSpec("convnext_small", convnext.convnext_small, 224, 256, "ConvNeXt-Small"),
        ModelSpec("swin_tiny", swin.swin_tiny, 224, 256,
                  "Swin-T — hierarchical windowed attention in the hand-written "
                  "CUDA kernel (timm-checkpoint-compatible)"),
        ModelSpec("swin_small", swin.swin_small, 224, 256, "Swin-S — deeper Swin variant"),
        ModelSpec("swin_base", swin.swin_base, 224, 256,
                  "Swin-B — embed 128 (timm-checkpoint-compatible, 87,768,224 params)"),
        ModelSpec("swin_micro", swin.swin_micro, 64, 64,
                  "Swin micro (2 stages @64px) — dev/CI windowed-attention model",
                  dev_only=True),
        ModelSpec("regnet_y_400mf", regnet.regnet_y_400mf, 224, 256,
                  "RegNet-Y 400MF — NAS-designed SE-gated grouped bottlenecks "
                  "(torchvision-checkpoint-compatible, 4,344,144 params)"),
        ModelSpec("regnet_y_1_6gf", regnet.regnet_y_1_6gf, 224, 256,
                  "RegNet-Y 1.6GF — larger Y variant "
                  "(torchvision-checkpoint-compatible, 11,202,430 params)"),
        ModelSpec("densenet121", densenet.densenet121, 224, 256,
                  "DenseNet-121 — dense connectivity (pre-act BN folded to FMA "
                  "pairs; torchvision-checkpoint-compatible, 7,978,856 params)"),
        ModelSpec("densenet169", densenet.densenet169, 224, 256,
                  "DenseNet-169 — deeper dense-connectivity variant "
                  "(torchvision-checkpoint-compatible, 14,149,480 params)"),
        ModelSpec("mobilenetv3_small", mobilenetv3.mobilenetv3_small, 224, 256,
                  "MobileNetV3-Small — single-image latency config (BASELINE cfg 1)"),
        ModelSpec("efficientnet_b4", efficientnet.efficientnet_b4, 380, 412,
                  "EfficientNet-B4 — mixed-resolution bucketing (BASELINE cfg 4)"),
        ModelSpec("efficientnet_b0", efficientnet.efficientnet_b0, 224, 256,
                  "EfficientNet-B0 — light variant"),
        ModelSpec("efficientnet_v2_s", efficientnet.efficientnet_v2_s, 384, 384,
                  "EfficientNetV2-S — fused-MBConv early stages "
                  "(torchvision-checkpoint-compatible)"),
        ModelSpec("efficientnet_v2_m", efficientnet.efficientnet_v2_m, 480, 480,
                  "EfficientNetV2-M — larger V2 variant @480px "
                  "(torchvision-checkpoint-compatible, 54,139,356 params)"),
    )
}


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models(include_dev: bool = True) -> list[str]:
    """All ported names; ``include_dev=False`` is the public API surface."""
    return sorted(n for n, s in _REGISTRY.items() if include_dev or not s.dev_only)
