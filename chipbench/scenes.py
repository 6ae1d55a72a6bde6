"""Seeded synthetic photographs as JPEG bytes: the image half of every
traffic mix.

A scene is a low-frequency colour gradient, a few filled shapes with hard
edges, blurred noise and a fine grain, encoded as a baseline JPEG. The
parameters come from the traffic file's ``images`` object:

- ``count``: distinct images made at set-up;
- ``long_side``: [lo, hi] px, spread log-uniformly over the images;
- ``aspects``: [w, h] ratios, each taken in both orientations;
- ``shapes``: [lo, hi] filled shapes a scene;
- ``blur_noise``, ``grain``: standard deviations, in levels of 0-255, of the
  blurred noise (drawn at 1/8 of the size and upscaled) and of the grain
  (a tile of noise drawn once a run);
- ``quality`` and ``subsampling`` ("4:2:0", "4:2:2" or "4:4:4") of the JPEG.

Every seed gets the same set of sizes in another order, so the work a run
does depends on the seed only through the content.
"""

from __future__ import annotations

import io
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, ImageDraw

_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
_GRAIN_TILE = 256


def image_sizes(params: dict, seed: int) -> list[tuple[int, int]]:
    """(height, width) of each image: long sides at the quantiles of a
    log-uniform law over ``long_side``, aspects in turn, then shuffled."""
    n = int(params["count"])
    lo, hi = params["long_side"]
    shapes = []
    aspects = [tuple(a) for a in params["aspects"]]
    for i in range(n):
        long_side = round(lo * (hi / lo) ** ((i + 0.5) / n))
        w_ratio, h_ratio = aspects[(i // 2) % len(aspects)]
        short = round(long_side * min(w_ratio, h_ratio) / max(w_ratio, h_ratio))
        shapes.append((short, long_side) if i % 2 == 0 else (long_side, short))
    order = np.random.default_rng([seed, 11]).permutation(n)
    return [shapes[i] for i in order]


def _render(params: dict, seed: int, index: int, size: tuple[int, int],
            grain: np.ndarray) -> bytes:
    h, w = size
    rng = np.random.default_rng([seed, 13, index])
    corners = rng.integers(0, 256, (2, 2, 3), dtype=np.uint8)
    img = Image.fromarray(corners, "RGB").resize((w, h), Image.BILINEAR)
    draw = ImageDraw.Draw(img)
    lo, hi = params["shapes"]
    for _ in range(int(rng.integers(lo, hi + 1))):
        x0, x1 = sorted(rng.integers(0, w, 2).tolist())
        y0, y1 = sorted(rng.integers(0, h, 2).tolist())
        colour = tuple(int(c) for c in rng.integers(0, 256, 3))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            draw.rectangle((x0, y0, x1, y1), fill=colour)
        elif kind == 1:
            draw.ellipse((x0, y0, x1, y1), fill=colour)
        else:
            pts = [(int(rng.integers(0, w)), int(rng.integers(0, h))) for _ in range(3)]
            draw.polygon(pts, fill=colour)
    base = np.asarray(img, dtype=np.float32)
    small = rng.standard_normal((max(1, h // 8), max(1, w // 8), 3), dtype=np.float32)
    blurred = np.asarray(
        Image.fromarray(np.clip(small * 32 + 128, 0, 255).astype(np.uint8), "RGB")
        .resize((w, h), Image.BICUBIC), dtype=np.float32) - 128.0
    oy, ox = rng.integers(0, _GRAIN_TILE, 2)
    reps = (math.ceil((h + oy) / _GRAIN_TILE), math.ceil((w + ox) / _GRAIN_TILE), 1)
    fine = np.tile(grain, reps)[oy:oy + h, ox:ox + w]
    pixels = base + blurred * (params["blur_noise"] / 32.0) + fine * params["grain"]
    out = Image.fromarray(np.clip(pixels + 0.5, 0, 255).astype(np.uint8), "RGB")
    buf = io.BytesIO()
    out.save(buf, "JPEG", quality=int(params["quality"]),
             subsampling=_SUBSAMPLING[params["subsampling"]], optimize=False,
             progressive=False)
    return buf.getvalue()


def make_images(params: dict, seed: int, workers: int = 8) -> list[bytes]:
    """The run's distinct JPEGs, in the order of ``image_sizes``."""
    sizes = image_sizes(params, seed)
    grain = np.random.default_rng([seed, 17]).standard_normal(
        (_GRAIN_TILE, _GRAIN_TILE, 3), dtype=np.float32)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda a: _render(params, seed, a[0], a[1], grain),
                             enumerate(sizes)))

