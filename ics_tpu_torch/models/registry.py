"""Registry of the ported models: name -> (constructor, preprocessing config).

Counterpart of ``ics_tpu/models/registry.py`` with the same ``ModelSpec``,
holding only the models this port runs. ``build(num_classes=..., device=...)``
returns a module with uninitialised parameters; the engine fills them from a
seed or from a state dict.
"""

from __future__ import annotations

from ics_tpu.models.registry import ModelSpec
from ics_tpu_torch.models import vit

_REGISTRY: dict[str, ModelSpec] = {
    spec.name: spec
    for spec in (
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
    )
}


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models(include_dev: bool = True) -> list[str]:
    """All ported names; ``include_dev=False`` is the public API surface."""
    return sorted(n for n, s in _REGISTRY.items() if include_dev or not s.dev_only)
