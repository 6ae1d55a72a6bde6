"""Resize + center-crop + normalize on the device (counterpart of
``ics_tpu/ops/preproc.py``).

The PIL BILINEAR (triangle) resize is two matmuls with per-image weight
matrices; the weights zero the canvas padding, so images of any size share
one staged uint8 canvas. Everything runs in fp32 (TF32 off, see
``ics_tpu_torch.disable_tf32``) and casts once at the end; the batch
dimension is written out where the JAX package used ``vmap``.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _triangle_weights(canvas: int, out_size: int, src_size: torch.Tensor,
                      scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Interpolation matrices [B, out_size, canvas] for PIL's triangle filter.

    Source coordinate of output pixel i: (i + offset + 0.5) * scale;
    ``src_size``, ``scale`` and ``offset`` are fp32 [B].
    """
    dev = scale.device
    filterscale = scale.clamp_min(1.0)[:, None, None]      # antialias when shrinking
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(canvas, dtype=torch.float32, device=dev)[None, None, :]
    center = (i + offset[:, None, None] + 0.5) * scale[:, None, None]
    w = (1.0 - ((j + 0.5 - center) / filterscale).abs()).clamp_min(0.0)
    # zero weights past the true extent and renormalise: PIL's edge handling
    w = torch.where(j < src_size[:, None, None], w, 0.0)
    return w / w.sum(dim=2, keepdim=True).clamp_min(1e-8)


def _resize_plan(h: torch.Tensor, w: torch.Tensor, out_size: int, resize_short: int):
    """Resize-shorter-side + center-crop as per-axis (scale, offset), on PIL's
    integer grid: the resized size is rounded, the crop offset floored."""
    h = h.float()
    w = w.float()
    short = torch.minimum(h, w)
    rh = torch.round(h * resize_short / short)
    rw = torch.round(w * resize_short / short)
    crop_y = torch.floor((rh - out_size) / 2.0)
    crop_x = torch.floor((rw - out_size) / 2.0)
    return (h / rh, crop_y), (w / rw, crop_x)


def apply_resize_weights(canvas: torch.Tensor, ry: torch.Tensor,
                         rx: torch.Tensor) -> torch.Tensor:
    """uint8 [B, CH, CW, 3] with ry [B, out, CH], rx [B, out, CW] ->
    fp32 [B, out, out, 3] in [0, 255] pixel space."""
    img = canvas.permute(0, 3, 1, 2).float()                  # [B, c, CH, CW]
    y = torch.einsum("boH,bcHW->bcoW", ry, img)
    y = torch.einsum("boW,bchW->bcho", rx, y)
    return y.permute(0, 2, 3, 1)                              # [B, out, out, c]


def normalize_pixels(y: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ImageNet-normalize an fp32 [0, 255]-space image and cast."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=y.device) * 255.0
    std_t = torch.tensor(std, dtype=torch.float32, device=y.device) * 255.0
    return ((y - mean_t) / std_t).to(dtype)


def preprocess_batch(canvas: torch.Tensor, sizes: torch.Tensor, out_size: int = 224,
                     resize_short: int = 256,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """canvas uint8 [B, CH, CW, 3] + true sizes int [B, 2] (h, w) ->
    normalized [B, out, out, 3] in ``dtype``."""
    _, ch, cw, _ = canvas.shape
    h, w = sizes[:, 0].float(), sizes[:, 1].float()
    (sy, oy), (sx, ox) = _resize_plan(h, w, out_size, resize_short)
    ry = _triangle_weights(ch, out_size, h, sy, oy)
    rx = _triangle_weights(cw, out_size, w, sx, ox)
    return normalize_pixels(apply_resize_weights(canvas, ry, rx), dtype=dtype)
