"""The reference's image path: JPEG bytes -> normalised NCHW float32.

Decoding is libjpeg's, through PIL (its default "fancy" chroma
upsampling). The resize is PIL's BILINEAR with antialiasing, written out:
the shorter side to ``resize_short`` (the other side rounded), then the
centre crop of ``image_size`` (offset floored), as one triangle-weight
matrix per axis, built in float64 and applied in float32 with TF32 off;
then ImageNet normalisation.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image

MEAN = np.array([0.485, 0.456, 0.406]) * 255.0
STD = np.array([0.229, 0.224, 0.225]) * 255.0


def decode(blob: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(blob)) as im:
        return np.array(im.convert("RGB"))


def axis_weights(src: int, resized: int, offset: int, out: int) -> np.ndarray:
    """[out, src] weights of output pixels offset..offset+out of a triangle
    resize from ``src`` to ``resized`` samples."""
    scale = src / resized
    support = max(scale, 1.0)
    centre = (np.arange(out)[:, None] + offset + 0.5) * scale
    j = np.arange(src)[None, :] + 0.5
    w = np.clip(1.0 - np.abs(j - centre) / support, 0.0, None)
    return w / w.sum(axis=1, keepdims=True)


def resize_plan(h: int, w: int, resize_short: int, out: int) -> tuple:
    short = min(h, w)
    rh, rw = round(h * resize_short / short), round(w * resize_short / short)
    return (axis_weights(h, rh, (rh - out) // 2, out),
            axis_weights(w, rw, (rw - out) // 2, out))


def preprocess(blobs: list[bytes], cfg: dict, device) -> torch.Tensor:
    """[N, 3, S, S] float32 on ``device``."""
    s = cfg["image_size"]
    mean = torch.tensor(MEAN, dtype=torch.float32, device=device)[:, None, None]
    std = torch.tensor(STD, dtype=torch.float32, device=device)[:, None, None]
    out = torch.empty((len(blobs), 3, s, s), dtype=torch.float32, device=device)
    for i, blob in enumerate(blobs):
        pixels = decode(blob)
        wy, wx = resize_plan(pixels.shape[0], pixels.shape[1], cfg["resize_short"], s)
        img = torch.from_numpy(pixels).to(device).permute(2, 0, 1).float()   # [3, H, W]
        wy_t = torch.from_numpy(wy).to(device=device, dtype=torch.float32)
        wx_t = torch.from_numpy(wx).to(device=device, dtype=torch.float32)
        out[i] = (wy_t @ img @ wx_t.t() - mean) / std
    return out
