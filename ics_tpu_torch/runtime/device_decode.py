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

import collections
import logging
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ics_tpu_torch.ops.jpeg_decode import (
    as_device_tensor,
    idct_plane,
    upsample_chroma,
    ycbcr_to_rgb,
)
from ics_tpu_torch.utils.metrics import registry

logger = logging.getLogger(__name__)

# default luma block canvas: 64x64 blocks = 512x512 px (matches the pixel
# staging canvas); the wide lane doubles it
LUMA_BLOCKS = 64
LUMA_BUCKETS = (64, 128)

# mode -> luma (h_samp, v_samp) relative to chroma
MODE_RATIOS = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}

STAGED_KEYS = ("y", "yq", "cb", "cq", "cr", "rq", "sizes")
SLOT_WAITS = ("staging_slot_waits", "flushes that waited for a staging slot")
SLOT_GROWS = ("staging_slot_grows", "staging slots made or grown by a flush")


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


class StagingSlot:
    """Host arrays of one coefficient lane (``mode``, ``luma_blocks``), reused
    flush after flush: the seven ``STAGED_KEYS`` arrays at ``rows`` rows, each
    a numpy view (``arrays``, the quant tables as ``uint16``) of a torch tensor
    (``tensors``, the tables as their ``int16`` bit pattern). With ``pin``
    the tensors are page-locked, so their copy to the card can run without
    blocking the host; ``event`` is then recorded on the stream after that
    copy, and the slot is restaged only once it has completed.

    ``stage`` writes a batch over what the slot's last occupant left: it
    keeps, for each row, the extent of the luma and chroma blocks that could
    be nonzero, and zeroes only what that extent covered beyond the new
    one, so the arrays hold the bytes a freshly zeroed staging would."""

    def __init__(self, mode: str, luma_blocks: int, rows: int, pin: bool = False):
        self.mode, self.luma_blocks, self.pin = mode, luma_blocks, pin
        self.event = torch.cuda.Event() if pin else None
        self.staged_rows = 0                # rows the last ``stage`` wrote
        self.grow(rows)

    def grow(self, rows: int) -> None:
        """Room for ``rows`` rows: new arrays, all zero."""
        cv, ch = _chroma_canvas(self.mode, self.luma_blocks)
        lb = self.luma_blocks
        shapes = {"y": ((rows, lb, lb, 64), np.int16), "cb": ((rows, cv, ch, 64), np.int16),
                  "cr": ((rows, cv, ch, 64), np.int16), "yq": ((rows, 64), np.int16),
                  "cq": ((rows, 64), np.int16), "rq": ((rows, 64), np.int16),
                  "sizes": ((rows, 2), np.int32)}
        self.tensors = {k: torch.from_numpy(np.zeros(shape, dtype))
                        for k, (shape, dtype) in shapes.items()}
        if self.pin:
            self.tensors = {k: t.pin_memory() for k, t in self.tensors.items()}
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}
        for k in ("yq", "cq", "rq"):
            self.arrays[k] = self.arrays[k].view(np.uint16)
        self.rows = rows
        # per row, (block rows, block columns) that may hold nonzero values
        self._luma = np.zeros((rows, 2), np.int64)
        self._chroma = np.zeros((rows, 2), np.int64)

    def stage(self, coeff_list: Sequence, rows: int) -> None:
        """Rows [0, n) from ``coeff_list`` (checked by the caller), rows
        [n, ``rows``) padding: zero coefficients and tables (they decode to
        zeros) and sizes 64, a sane extent for the resize plan."""
        a = self.arrays
        cbv, cbh_ = _chroma_canvas(self.mode, self.luma_blocks)
        for i in range(rows):
            co = coeff_list[i] if i < len(coeff_list) else None
            luma = co.components[0]["coeffs"] if co is not None else None
            color = co is not None and self.mode != "gray"
            self._luma[i] = _restage(a["y"][i], self._luma[i],
                                     luma.shape[:2] if luma is not None else (0, 0))
            if luma is not None:
                a["y"][i, :luma.shape[0], :luma.shape[1]] = luma
                a["yq"][i] = co.components[0]["quant"]
                a["sizes"][i] = (co.height, co.width)
            else:
                a["yq"][i] = 0
                a["sizes"][i] = 64
            if not color:
                # zero chroma coeffs + zero quant = neutral 128 plane
                for key, q in (("cb", "cq"), ("cr", "rq")):
                    _restage(a[key][i], self._chroma[i], (0, 0))
                    a[q][i] = 0
                self._chroma[i] = 0
                continue
            cbc, crc = co.components[1], co.components[2]
            ch, cw = cbc["coeffs"].shape[:2]
            for key, q, comp in (("cb", "cq", cbc), ("cr", "rq", crc)):
                plane = a[key][i]
                _restage(plane, self._chroma[i], (ch, cw))
                plane[:ch, :cw] = comp["coeffs"]
                # edge-replicate chroma DC into the padding blocks: the fancy
                # upsampler reads one neighbor past the image edge, and
                # neutral-grey padding would pull border chroma 25% toward
                # grey (lane divergence vs the host decoder). Replicating the
                # edge blocks' DC keeps the neighbor at the edge value.
                if ch < cbv:
                    plane[ch, :cw, 0] = comp["coeffs"][ch - 1, :, 0]
                if cw < cbh_:
                    plane[:ch, cw, 0] = comp["coeffs"][:, cw - 1, 0]
                if ch < cbv and cw < cbh_:
                    # the corner block too: without it the bottom-right image
                    # corner's right-neighbor column decodes to neutral grey
                    plane[ch, cw, 0] = comp["coeffs"][ch - 1, cw - 1, 0]
                a[q][i] = comp["quant"]
            self._chroma[i] = (min(ch + 1, cbv), min(cw + 1, cbh_))
        self.staged_rows = rows


def _restage(plane: np.ndarray, old, new) -> tuple:
    """Zero the blocks of ``plane`` [H, W, 64] inside the extent ``old`` and
    outside ``new``, both (block rows, block columns); returns ``new``."""
    (oh, ow), (nh, nw) = old, new
    if oh > nh:
        plane[nh:oh, :ow] = 0
    if ow > nw:
        plane[:min(oh, nh), nw:ow] = 0
    return new


class StagedBatch(dict):
    """A staged batch (the ``STAGED_KEYS`` arrays of its n images) whose
    arrays are the first rows of ``slot``; the slot holds the batch padded to
    the ``slot.staged_rows`` it was staged at. A copy of it (``dict(...)``)
    is a plain staged batch."""

    def __init__(self, arrays: dict, slot: StagingSlot):
        super().__init__(arrays)
        self.slot = slot


def stage_coefficient_batch(
    coeff_list: Sequence,
    luma_blocks: int = LUMA_BLOCKS,
    mode: str = "420",
    slot: Optional[StagingSlot] = None,
    rows: Optional[int] = None,
) -> Optional[dict]:
    """Stage a batch of same-mode JpegCoefficients onto fixed block canvases.

    Returns None if any image doesn't match ``mode`` or exceeds the canvas
    (callers route by classify_coefficients, so this is defense in depth).
    By default the arrays are new, of the batch's own rows. With ``slot`` (of
    this lane, at least ``rows`` rows) the batch is written into the slot,
    padded to ``rows`` rows (default: the batch's), and a ``StagedBatch`` of
    the slot's first n rows is returned.
    """
    cbv, cbh_ = _chroma_canvas(mode, luma_blocks)
    for co in coeff_list:
        cls = classify_coefficients(co, luma_buckets=(luma_blocks,))
        if cls is None or cls[0] != mode:
            return None
        if mode != "gray":
            ch, cw = co.components[1]["coeffs"].shape[:2]
            if ch > cbv or cw > cbh_:
                return None
    n = len(coeff_list)
    if slot is None:
        fresh = StagingSlot(mode, luma_blocks, n)
        fresh.stage(coeff_list, n)
        return fresh.arrays
    slot.stage(coeff_list, n if rows is None else rows)
    return StagedBatch({k: slot.arrays[k][:n] for k in STAGED_KEYS}, slot)


def pad_staged(staged: dict, rows: int) -> dict:
    """A new staged batch of ``rows`` rows: ``staged`` and padding rows of
    zero coefficients and tables, sizes 64 (what ``StagingSlot.stage`` pads
    with)."""
    n = staged["y"].shape[0]
    if n >= rows:
        return staged
    padded = {}
    for k, v in staged.items():             # numpy's zeros: padding pages stay untouched
        padded[k] = np.zeros((rows, *v.shape[1:]), v.dtype)
        padded[k][:n] = v
    padded["sizes"][n:] = 64
    return padded


class StagingPool:
    """The host slots of one coefficient lane, handed out one a flush.

    ``reserve`` makes the lane's first ``RESERVED`` slots (the engine's
    warm-up, so page-locking lands in set-up); ``acquire`` hands out a free
    slot with room for a flush, making one while fewer than ``SLOTS``
    exist, else waiting for a ``release``, then for the slot's last copy.
    The service holds a slot from staging until the flush's resolver has
    returned, so with the batcher's two-deep pipeline a lane holds two; the
    third covers a warm-up or an unpipelined flush beside them. Each wait
    counts in the registry's ``staging_slot_waits``, each slot made or grown
    by a flush in ``staging_slot_grows``."""

    RESERVED = 2
    SLOTS = 3
    STUCK_S = 60.0      # a wait this long makes one more slot: a slot was never handed back

    def __init__(self, mode: str, luma_blocks: int, pin: bool):
        self.mode, self.luma_blocks, self.pin = mode, luma_blocks, pin
        self._free: collections.deque = collections.deque()
        self._made = 0
        self._cond = threading.Condition()

    def _slot(self, rows: int) -> StagingSlot:
        return StagingSlot(self.mode, self.luma_blocks, rows, self.pin)

    def reserve(self, rows: int) -> None:
        with self._cond:
            while self._made < self.RESERVED:
                self._free.append(self._slot(rows))
                self._made += 1
            for slot in self._free:
                if slot.rows < rows:
                    slot.grow(rows)

    def acquire(self, rows: int) -> StagingSlot:
        grown = False
        with self._cond:
            if not self._free and self._made >= self.SLOTS:
                registry.counter(*SLOT_WAITS).inc()
                self._cond.wait_for(lambda: self._free, timeout=self.STUCK_S)
            slot = self._free.popleft() if self._free else None
            if slot is None:
                self._made += 1
        if slot is None:
            logger.info("decode lane %s/%dpx: staging slot %d", self.mode,
                        self.luma_blocks * 8, self._made)
            slot, grown = self._slot(rows), True
        elif slot.event is not None and not slot.event.query():
            registry.counter(*SLOT_WAITS).inc()
            slot.event.synchronize()
        if slot.rows < rows:
            slot.grow(rows)
            grown = True
        if grown:
            registry.counter(*SLOT_GROWS).inc()
        return slot

    def release(self, slot: StagingSlot) -> None:
        with self._cond:
            self._free.append(slot)
            self._cond.notify()


def to_device(staged: dict, device, non_blocking: bool = False) -> dict:
    """Host staged batch -> tensors on ``device``, dtypes as they are
    (uint16 tables as their int16 bit pattern); ``non_blocking`` for
    page-locked tensors."""
    return {key: as_device_tensor(staged[key], device, non_blocking) for key in STAGED_KEYS}


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
