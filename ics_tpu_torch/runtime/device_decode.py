"""Batched device-decode ingestion (counterpart of ``ics_tpu/runtime/device_decode.py``).

Host: Huffman entropy decode only (``imgcodec.jpeg_coefficients``, the
port's own decoder). Device: one step runs dequant -> iDCT matmuls ->
chroma upsample -> YCbCr->RGB -> resize/crop/normalize -> model forward for
the whole batch.

Batches are staged on fixed block canvases, one lane per (sampling mode,
luma bucket): 4:2:0 / 4:2:2 / 4:4:4 / grayscale, luma canvases of 64 blocks
(<=512 px, the common case) and 128 blocks (<=1024 px). Grayscale stages as
4:4:4 with zeroed chroma coefficients: dequant gives a flat 128 plane, i.e.
exactly neutral Cb/Cr. Anything else (exotic samplings, >1024 px) goes to
the host decoder upstream. Int16 coefficients and uint16 quant tables cross
to the device as they are (the tables as their int16 bit pattern) and are
widened there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ics_tpu_torch.ops.jpeg_decode import (
    as_device_tensor,
    idct_plane,
    upsample_chroma,
    ycbcr_to_rgb,
)

# default luma block canvas: 64x64 blocks = 512x512 px (matches the pixel
# staging canvas); the wide lane doubles it
LUMA_BLOCKS = 64
LUMA_BUCKETS = (64, 128)

# mode -> luma (h_samp, v_samp) relative to chroma
MODE_RATIOS = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}

STAGED_KEYS = ("y", "yq", "cb", "cq", "cr", "rq", "sizes")


def classify_coefficients(co, luma_buckets: Sequence[int] = LUMA_BUCKETS):
    """-> (mode, luma_blocks) for the batched device lane, or None.

    mode in {"420", "422", "444", "gray"}; luma_blocks is the smallest
    bucket that fits the image.
    """
    if co is None or co.width < 1 or co.height < 1:
        return None
    if len(co.components) == 1:
        mode = "gray"
    elif len(co.components) == 3:
        yc, cbc, crc = co.components
        if (
            cbc["h_samp"] != crc["h_samp"]
            or cbc["v_samp"] != crc["v_samp"]
            or yc["h_samp"] % cbc["h_samp"]
            or yc["v_samp"] % cbc["v_samp"]
        ):
            return None
        ratio = (yc["h_samp"] // cbc["h_samp"], yc["v_samp"] // cbc["v_samp"])
        mode = {v: k for k, v in MODE_RATIOS.items()}.get(ratio)
        if mode is None:
            return None
    else:
        return None
    ybh, ybw = co.components[0]["coeffs"].shape[:2]
    for bucket in sorted(luma_buckets):
        if ybh <= bucket and ybw <= bucket:
            return mode, bucket
    return None


def _chroma_canvas(mode: str, luma_blocks: int) -> tuple[int, int]:
    hr, vr = MODE_RATIOS["444" if mode == "gray" else mode]
    return luma_blocks // vr, luma_blocks // hr


def stage_coefficient_batch(
    coeff_list: Sequence,
    luma_blocks: int = LUMA_BLOCKS,
    mode: str = "420",
) -> Optional[dict]:
    """Stage a batch of same-mode JpegCoefficients onto fixed block canvases.

    Returns None if any image doesn't match ``mode`` or exceeds the canvas
    (callers route by classify_coefficients, so this is defense in depth).
    """
    n = len(coeff_list)
    cbv, cbh_ = _chroma_canvas(mode, luma_blocks)
    y = np.zeros((n, luma_blocks, luma_blocks, 64), np.int16)
    cb = np.zeros((n, cbv, cbh_, 64), np.int16)
    cr = np.zeros((n, cbv, cbh_, 64), np.int16)
    yq = np.zeros((n, 64), np.uint16)
    cq = np.zeros((n, 64), np.uint16)
    rq = np.zeros((n, 64), np.uint16)
    sizes = np.zeros((n, 2), np.int32)
    for i, co in enumerate(coeff_list):
        cls = classify_coefficients(co, luma_buckets=(luma_blocks,))
        if cls is None or cls[0] != mode:
            return None
        yc = co.components[0]
        ybh, ybw = yc["coeffs"].shape[:2]
        y[i, :ybh, :ybw] = yc["coeffs"]
        yq[i] = yc["quant"]
        sizes[i] = (co.height, co.width)
        if mode == "gray":
            continue  # zero chroma coeffs + zero quant = neutral 128 plane
        cbc, crc = co.components[1], co.components[2]
        ch, cw = cbc["coeffs"].shape[:2]
        if ch > cbv or cw > cbh_:
            return None
        cb[i, :ch, :cw] = cbc["coeffs"]
        cr[i, :ch, :cw] = crc["coeffs"]
        # edge-replicate chroma DC into the padding blocks: the fancy
        # upsampler reads one neighbor past the image edge, and neutral-grey
        # padding would pull border chroma 25% toward grey (lane divergence
        # vs the host decoder). Replicating the edge blocks' DC keeps the
        # neighbor at the edge value.
        if ch < cbv:
            cb[i, ch, :cw, 0] = cbc["coeffs"][ch - 1, :, 0]
            cr[i, ch, :cw, 0] = crc["coeffs"][ch - 1, :, 0]
        if cw < cbh_:
            cb[i, :ch, cw, 0] = cbc["coeffs"][:, cw - 1, 0]
            cr[i, :ch, cw, 0] = crc["coeffs"][:, cw - 1, 0]
        if ch < cbv and cw < cbh_:
            # the corner block too: without it the bottom-right image
            # corner's right-neighbor column decodes to neutral grey
            cb[i, ch, cw, 0] = cbc["coeffs"][ch - 1, cw - 1, 0]
            cr[i, ch, cw, 0] = crc["coeffs"][ch - 1, cw - 1, 0]
        cq[i] = cbc["quant"]
        rq[i] = crc["quant"]
    return {
        "y": y, "cb": cb, "cr": cr,
        "yq": yq, "cq": cq, "rq": rq,
        "sizes": sizes,
    }


def to_device(staged: dict, device) -> dict:
    """Host staged batch -> tensors on ``device``, dtypes as they are
    (uint16 tables as their int16 bit pattern)."""
    return {key: as_device_tensor(staged[key], device) for key in STAGED_KEYS}


def clamp_to_extent(plane: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[B, ..., H, W] planes with every row at or past ``rows[b]`` replaced by
    row ``rows[b] - 1`` and every column at or past ``cols[b]`` by column
    ``cols[b] - 1``: each plane continues its edge, as libjpeg's upsampler
    sees a component past its downsampled size."""
    b, h, w = plane.shape[0], plane.shape[-2], plane.shape[-1]
    ones = (1,) * (plane.dim() - 3)
    dev = plane.device
    ri = torch.minimum(torch.arange(h, device=dev), (rows - 1).clamp_min(0)[:, None])
    ci = torch.minimum(torch.arange(w, device=dev), (cols - 1).clamp_min(0)[:, None])
    plane = plane.gather(-2, ri.view(b, *ones, h, 1).expand(plane.shape))
    return plane.gather(-1, ci.view(b, *ones, 1, w).expand(plane.shape))


def decode_batch_to_canvas(staged: dict, dtype=torch.float32, mode: str = "420") -> torch.Tensor:
    """Staged coefficient batch (tensors, ``sizes`` [B, 2] (h, w) among them)
    -> RGB canvas [B, S, S, 3] (S = 8*blocks), batched over B.

    The padded regions decode to garbage pixels; downstream preproc masks
    them out via the true ``sizes`` (same contract as the pixel canvas).
    Subsampled chroma is continued from its last real row and column
    (``ceil(h / v)``, ``ceil(w / h)`` samples) before the fancy upsampling,
    so the image's last pixels blend with the edge as libjpeg's do, not with
    the block padding past it: where an image's height (width) is even, its
    last row (column) differs from the JAX package's function, which reads
    the padding; every other pixel of the image is that function's. Cb and Cr
    go through each step together, and grayscale's neutral chroma (zero
    coefficients, zero tables: exactly 128) is not computed: R = G = B = Y,
    the same bits."""
    yp = idct_plane(staged["y"], staged["yq"])
    if mode == "gray":
        return torch.clamp(torch.round(yp), 0.0, 255.0)[..., None].expand(
            *yp.shape, 3).to(dtype)
    hr, vr = MODE_RATIOS[mode]
    chroma = idct_plane(torch.stack([staged["cb"], staged["cr"]], 1),
                        torch.stack([staged["cq"], staged["rq"]], 1))      # [B, 2, H, W]
    if (hr, vr) != (1, 1):
        sizes = staged["sizes"].long()
        chroma = clamp_to_extent(chroma, (sizes[:, 0] + vr - 1) // vr,
                                 (sizes[:, 1] + hr - 1) // hr)
    chroma = upsample_chroma(chroma, hr, vr)
    return ycbcr_to_rgb(yp, chroma[:, 0], chroma[:, 1]).to(dtype)


def make_fused_decode_infer_step(model, spec, dtype=torch.bfloat16, top_k: int = 5,
                                 mode: str = "420", multi_label: bool = False, mesh=None):
    """Returns step: coefficient batch (tensors on the model's device) ->
    (top_idx, top_scores).

    ``model`` is a folded model (``apply_folded``) in ``dtype``. Everything
    after the entropy decode runs on the device: the decode in fp32, the
    resize/crop/normalize in fp32 cast once to ``dtype``, the forward, and
    softmax (sigmoid when multi-label) with top-k.

    With ``mesh`` (the engine's ``parallel.mesh.MeshModel``, which holds
    ``model``'s copies), the step takes the staged arrays on the host
    instead: their rows are split over the mesh's data groups, each group
    runs the step on its own copy (the head split over ``model`` where it
    is), and the top-k is gathered on the first position's device."""
    from ics_tpu_torch.ops.preproc import preprocess_batch

    @torch.inference_mode()
    def step(y, yq, cb, cq, cr, rq, sizes, model=model):
        staged = {"y": y, "yq": yq, "cb": cb, "cq": cq, "cr": cr, "rq": rq, "sizes": sizes}
        canvas = decode_batch_to_canvas(staged, dtype=torch.float32, mode=mode)
        x = preprocess_batch(canvas, sizes, out_size=spec.image_size,
                             resize_short=spec.resize_short, dtype=dtype)
        logits = model.apply_folded(x).float()
        probs = torch.sigmoid(logits) if multi_label else torch.softmax(logits, dim=-1)
        top_scores, top_idx = torch.topk(probs, top_k, dim=-1)
        return top_idx, top_scores

    if mesh is None:
        return step
    return lambda *arrays: mesh.map(lambda group, *t: step(*t, model=group), *arrays)
