"""Training augmentation on the device, fused into the resize matmuls
(counterpart of ``ics_tpu/ops/augment.py``).

RandomResizedCrop and the horizontal flip change only the per-image
``[out, canvas]`` weight matrices of the two interpolation matmuls that
serving's preprocess uses (``ops/preproc.py``, the same ``(scale, offset)``
parameterisation of the triangle weights), so augmentation costs no extra
pass over the pixels. Colour jitter is a per-image affine in pixel space.
Mixup and CutMix pair each image with its batch neighbour (a roll by one).

Drawing is split from applying. ``draw_plan`` and ``draw_mix`` take the
random numbers from a ``torch.Generator`` (on the host: a few scalars an
image); ``apply_plan`` (the reference's ``augment_batch``) and ``mix_batch``
apply a plan on the device. JAX keys and torch generators give different
bits from one seed, so the tests hand the JAX-drawn plan to the apply
functions and test the draws by their ranges and statistics.

Geometry as the reference's: the sampled box is clamped to the true extent
(no rejection sampling), and the filter may read a few real pixels just
outside the box.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ics_tpu_torch.ops.preproc import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _triangle_weights,
    apply_resize_weights,
    normalize_pixels,
)

# Rec. 601 luma, PIL's convert("L") weighting
_LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The augmentation recipe (defaults: area-scale crop in [0.35, 1], 3:4 to
    4:3 aspect, 50 % horizontal flip, no colour jitter, no mixing, no label
    smoothing)."""

    scale_range: Tuple[float, float] = (0.35, 1.0)
    ratio_range: Tuple[float, float] = (0.75, 4.0 / 3.0)
    flip_prob: float = 0.5
    brightness: float = 0.0   # factor jitter: b ~ U[1-x, 1+x]
    contrast: float = 0.0
    saturation: float = 0.0
    mixup_alpha: float = 0.0  # 0 disables; 0.2 is the standard setting
    cutmix_alpha: float = 0.0  # 0 disables; 1.0 is the standard setting
    label_smoothing: float = 0.0

    def __post_init__(self):
        lo, hi = self.scale_range
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError(f"scale_range inválido: {self.scale_range}")
        rlo, rhi = self.ratio_range
        if not (0.0 < rlo <= rhi):
            raise ValueError(f"ratio_range inválido: {self.ratio_range}")
        if not (0.0 <= self.flip_prob <= 1.0):
            raise ValueError(f"flip_prob inválido: {self.flip_prob}")
        for name in ("brightness", "contrast", "saturation"):
            v = getattr(self, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{name} inválido: {v} (esperado [0, 1))")
        if self.mixup_alpha < 0.0:
            raise ValueError(f"mixup_alpha inválido: {self.mixup_alpha}")
        if self.cutmix_alpha < 0.0:
            raise ValueError(f"cutmix_alpha inválido: {self.cutmix_alpha}")
        if not (0.0 <= self.label_smoothing < 1.0):
            raise ValueError(f"label_smoothing inválido: {self.label_smoothing}")

    @property
    def jitters(self) -> bool:
        return self.brightness > 0.0 or self.contrast > 0.0 or self.saturation > 0.0


class AugmentPlan(NamedTuple):
    """What one batch's crop, flip and jitter are, fp32 [B] each (flip bool):
    per axis the ``(scale, offset)`` of ``_triangle_weights`` (source centre
    of output pixel i at ``(i + offset + 0.5) * scale``), and the jitter
    factors (1 where that jitter is off)."""

    scale_y: torch.Tensor
    offset_y: torch.Tensor
    scale_x: torch.Tensor
    offset_x: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor

    def to(self, device) -> "AugmentPlan":
        return AugmentPlan(*(t.to(device) for t in self))


def _uniform(n: int, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=generator, dtype=torch.float32)


def _crop_flip_plan(h: torch.Tensor, w: torch.Tensor, out_size: int, cfg: AugmentConfig,
                    generator: torch.Generator):
    """RandomResizedCrop boxes and flips for images of true sizes ``h``, ``w``
    (fp32 [B]): per axis ``(scale, offset)`` for a crop of ``crop_h`` rows
    from ``y0`` onto ``out_size`` rows (``scale = crop_h / out_size``,
    ``offset = y0 / scale``), and the flips."""
    n = h.shape[0]
    area_frac = _uniform(n, cfg.scale_range[0], cfg.scale_range[1], generator)
    ratio = torch.exp(_uniform(n, math.log(cfg.ratio_range[0]), math.log(cfg.ratio_range[1]),
                               generator))                  # crop aspect w / h
    area = area_frac * h * w
    crop_h = torch.minimum(torch.sqrt(area / ratio).clamp_min(1.0), h)
    crop_w = torch.minimum(torch.sqrt(area * ratio).clamp_min(1.0), w)
    y0 = torch.rand(n, generator=generator) * (h - crop_h)
    x0 = torch.rand(n, generator=generator) * (w - crop_w)
    flip = torch.rand(n, generator=generator) < cfg.flip_prob
    scale_y = crop_h / out_size
    scale_x = crop_w / out_size
    return (scale_y, y0 / scale_y), (scale_x, x0 / scale_x), flip


def draw_plan(sizes: torch.Tensor, out_size: int, cfg: AugmentConfig,
              generator: torch.Generator) -> AugmentPlan:
    """The crop, flip and jitter of a batch with true sizes ``sizes`` (int
    [B, 2], (h, w)), drawn from ``generator`` on the host."""
    sizes = sizes.detach().cpu()
    h, w = sizes[:, 0].float(), sizes[:, 1].float()
    (sy, oy), (sx, ox), flip = _crop_flip_plan(h, w, out_size, cfg, generator)
    n = h.shape[0]
    ones = torch.ones(n)
    jitter = [_uniform(n, 1.0 - x, 1.0 + x, generator) if x > 0.0 else ones
              for x in (cfg.brightness, cfg.contrast, cfg.saturation)]
    return AugmentPlan(sy, oy, sx, ox, flip, *jitter)


def _color_jitter(y: torch.Tensor, plan: AugmentPlan, cfg: AugmentConfig) -> torch.Tensor:
    """Brightness, contrast, saturation in that order, each a per-image affine
    in [0, 255] pixel space; y fp32 [B, out, out, 3]."""
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=y.device)
    if cfg.brightness > 0.0:
        y = y * plan.brightness[:, None, None, None]
    if cfg.contrast > 0.0:
        mean = (y @ luma).mean(dim=(1, 2))[:, None, None, None]
        y = (y - mean) * plan.contrast[:, None, None, None] + mean
    if cfg.saturation > 0.0:
        gray = (y @ luma)[..., None]
        y = gray + (y - gray) * plan.saturation[:, None, None, None]
    return y.clamp(0.0, 255.0)


def apply_plan(canvas: torch.Tensor, sizes: torch.Tensor, plan: AugmentPlan,
               out_size: int = 224, cfg: AugmentConfig = AugmentConfig(),
               mean=IMAGENET_MEAN, std=IMAGENET_STD,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """canvas uint8 [B, CH, CW, 3], true sizes [B, 2] and a plan ->
    augmented, normalised [B, out, out, 3] in ``dtype``, on the canvas's
    device. A flip reverses the rows of the column-weight matrix: output
    column i samples where column out-1-i would."""
    _, ch, cw, _ = canvas.shape
    dev = canvas.device
    plan = plan.to(dev)
    h, w = sizes[:, 0].to(dev).float(), sizes[:, 1].to(dev).float()
    ry = _triangle_weights(ch, out_size, h, plan.scale_y, plan.offset_y)
    rx = _triangle_weights(cw, out_size, w, plan.scale_x, plan.offset_x)
    rx = torch.where(plan.flip[:, None, None], rx.flip(1), rx)
    y = apply_resize_weights(canvas, ry, rx)
    if cfg.jitters:
        y = _color_jitter(y, plan, cfg)
    return normalize_pixels(y, mean, std, dtype)


def smooth_labels(labels: torch.Tensor, num_classes: int,
                  smoothing: float = 0.0) -> torch.Tensor:
    """int labels [B] -> target distribution [B, num_classes] with uniform
    label smoothing (the true class keeps 1 - s, plus its share of s)."""
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    if smoothing <= 0.0:
        return onehot
    return onehot * (1.0 - smoothing) + smoothing / num_classes


def smooth_multilabel(targets: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """Multi-hot [B, C] targets, each class moved ``smoothing / 2`` toward
    0.5 (every class is its own two-way problem)."""
    if smoothing <= 0.0:
        return targets
    return targets * (1.0 - smoothing) + smoothing / 2.0


class MixPlan(NamedTuple):
    """One batch's mixing: ``kind`` "mixup", "cutmix" or None; ``lam`` the
    Beta draw folded to [0.5, 1] (the own image dominates); for CutMix the
    box centre as fractions of the image's height and width, in [0, 1)."""

    kind: Optional[str]
    lam: float = 1.0
    cy: float = 0.0
    cx: float = 0.0


def draw_mix(cfg: AugmentConfig, generator: torch.Generator) -> MixPlan:
    """The mixing of one batch: mixup, CutMix or, with both alphas set, one of
    the two with even odds (the timm recipe)."""
    use_mixup, use_cutmix = cfg.mixup_alpha > 0.0, cfg.cutmix_alpha > 0.0
    if not (use_mixup or use_cutmix):
        return MixPlan(None)
    if use_mixup and use_cutmix:
        kind = "mixup" if float(torch.rand((), generator=generator)) < 0.5 else "cutmix"
    else:
        kind = "mixup" if use_mixup else "cutmix"
    alpha = cfg.mixup_alpha if kind == "mixup" else cfg.cutmix_alpha
    # torch's Beta sampler takes no generator: numpy's, seeded from this one
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    lam = max(lam, 1.0 - lam)
    cy, cx = (float(v) for v in torch.rand(2, generator=generator))
    return MixPlan(kind, lam, cy, cx)


def _rolled(images: torch.Tensor, targets: torch.Tensor, rolled: Optional[tuple]) -> tuple:
    return rolled if rolled is not None else (images.roll(1, 0), targets.roll(1, 0))


def mixup(images: torch.Tensor, targets: torch.Tensor, lam: float,
          rolled: Optional[tuple] = None):
    """Blend each example with its batch neighbour (a roll by one) by ``lam``;
    targets are probability rows [B, C]. ``rolled``: the neighbours
    (images, targets) where the batch is a chunk of a larger one
    (``mix_batch``)."""
    r_images, r_targets = _rolled(images, targets, rolled)
    mixed_images = (torch.tensor(lam, dtype=images.dtype) * images
                    + torch.tensor(1.0 - lam, dtype=images.dtype) * r_images)
    mixed_targets = lam * targets + (1.0 - lam) * r_targets
    return mixed_images, mixed_targets


def cutmix(images: torch.Tensor, targets: torch.Tensor, lam: float, cy: float, cx: float,
           rolled: Optional[tuple] = None):
    """Paste a box of area fraction ``1 - lam`` centred at (cy H, cx W) from
    the batch neighbour; the targets mix by the box's area after it is
    clipped to the image. ``rolled`` as ``mixup``'s."""
    r_images, r_targets = _rolled(images, targets, rolled)
    _, h, w, _ = images.shape
    cut = math.sqrt(1.0 - lam)
    cut_h, cut_w = torch.tensor(cut * h), torch.tensor(cut * w)   # fp32, as the reference
    y, x = torch.tensor(cy) * h, torch.tensor(cx) * w
    y0, y1 = (y - cut_h / 2.0).clamp(0.0, h), (y + cut_h / 2.0).clamp(0.0, h)
    x0, x1 = (x - cut_w / 2.0).clamp(0.0, w), (x + cut_w / 2.0).clamp(0.0, w)
    rows = torch.arange(h, dtype=torch.float32)
    cols = torch.arange(w, dtype=torch.float32)
    box = (((rows >= y0) & (rows < y1))[:, None] & ((cols >= x0) & (cols < x1))[None, :]).float()
    lam_adj = 1.0 - float(box.mean())
    mask = box.to(device=images.device, dtype=images.dtype)[None, :, :, None]
    mixed_images = images * (1.0 - mask) + r_images * mask
    mixed_targets = lam_adj * targets + (1.0 - lam_adj) * r_targets
    return mixed_images, mixed_targets


def mix_batch(images: torch.Tensor, targets: torch.Tensor, plan: MixPlan,
              rolled: Optional[tuple] = None):
    """Apply a batch's ``MixPlan``. Where ``images`` and ``targets`` are a
    chunk of rows of the batch (a data-parallel step), ``rolled`` holds the
    batch's roll by one over the chunk's rows, (images, targets): its first
    row is the previous chunk's last."""
    if plan.kind == "mixup":
        return mixup(images, targets, plan.lam, rolled)
    if plan.kind == "cutmix":
        return cutmix(images, targets, plan.lam, plan.cy, plan.cx, rolled)
    return images, targets
