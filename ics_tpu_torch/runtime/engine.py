"""Inference engine for the pixel lane (counterpart of ``ics_tpu/runtime/engine.py``).

One step per batch bucket: uint8 canvas -> fp32 resize/crop/normalize on
the device -> forward in the serving dtype (attention in the flash kernel)
-> softmax (or sigmoid when multi-label) and top-k. Requests are padded up
to the nearest bucket, so the device sees a small fixed set of shapes.
PyTorch runs eagerly: the first call on a shape pays the kernel builds and
cuBLAS/cuDNN plan selection, and is counted as the compile.

Not ported yet: the mesh, pipeline-parallel, TTA, explain, embed and
JPEG-coefficient lanes.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ics_tpu_torch import disable_tf32, get_device
from ics_tpu_torch.models.registry import ModelSpec, get_model
from ics_tpu_torch.ops import launch_counts
from ics_tpu_torch.ops.preproc import preprocess_batch

logger = logging.getLogger(__name__)

TOP_K = 5
PAD_SIZE = 256  # true (h, w) given to padding rows: any sane extent will do
_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


class InferenceEngine:
    """Synchronous engine; the async batcher drives it from executor threads."""

    def __init__(
        self,
        model_name: str,
        num_classes: int = 1000,
        precision: str = "bf16",
        buckets: Sequence[int] = (1, 8, 32, 128),
        canvas: int = 512,
        seed: int = 0,
        state_dict: Optional[dict] = None,
        multi_label: bool = False,
        device=None,
    ):
        if precision not in _DTYPES:
            raise ValueError(f"precision must be one of {sorted(_DTYPES)}; got {precision!r}")
        self.spec: ModelSpec = get_model(model_name)
        self.model_name = model_name
        self.num_classes = num_classes
        self.precision = precision
        self.dtype = _DTYPES[precision]
        # multi-label models score every class with its own sigmoid
        self.multi_label = bool(multi_label)
        self.buckets = tuple(sorted(set(buckets)))
        self.canvas = canvas
        self.device = get_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        # weights are drawn on the CPU from the seed, so one seed gives the
        # same model on every device, then cast (every fp32 tensor, as the
        # JAX engine casts every fp32 leaf) and moved
        model = self.spec.build(num_classes=num_classes)
        if state_dict is None:
            model.init_weights(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.fold().to(device=self.device, dtype=self.dtype).eval()
        self._compiled_shapes: set = set()
        self._stats = {
            "batches": 0, "images": 0, "total_device_ms": 0.0, "compiles": 0,
        }

    def _record_step(self, key, dt_ms: float, n: int, record: bool = True) -> None:
        """The FIRST call on a shape key is a compile (counted, kept out of
        total_device_ms); ``record=False`` keeps warmup out of the stats."""
        new_shape = key not in self._compiled_shapes
        self._compiled_shapes.add(key)
        if not record:
            return
        self._stats["batches"] += 1
        self._stats["images"] += n
        if new_shape:
            self._stats["compiles"] += 1
        else:
            self._stats["total_device_ms"] += dt_ms

    def _top_k(self) -> int:
        # multi-label returns every class: each sigmoid is its own decision
        return self.num_classes if self.multi_label else min(TOP_K, self.num_classes)

    @torch.inference_mode()
    def _step(self, canvas: torch.Tensor, sizes: torch.Tensor):
        x = preprocess_batch(
            canvas, sizes, out_size=self.spec.image_size,
            resize_short=self.spec.resize_short, dtype=self.dtype,
        )
        logits = self.model.apply_folded(x).float()
        probs = torch.sigmoid(logits) if self.multi_label else torch.softmax(logits, dim=-1)
        scores, idx = torch.topk(probs, self._top_k(), dim=-1)
        return idx, scores

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _pad(self, canvas: np.ndarray, sizes: np.ndarray):
        n = canvas.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            canvas = np.concatenate(
                [canvas, np.zeros((bucket - n, *canvas.shape[1:]), np.uint8)]
            )
            sizes = np.concatenate(
                [sizes, np.full((bucket - n, 2), PAD_SIZE, np.int32)]
            )
        return canvas, sizes, bucket

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        for b in buckets or self.buckets:
            canvas = np.zeros((b, self.canvas, self.canvas, 3), np.uint8)
            sizes = np.full((b, 2), PAD_SIZE, np.int32)
            idx, _ = self._step(*self._to_device(canvas, sizes))
            idx.cpu()
            self._compiled_shapes.add((b, self.canvas))
            logger.info("warmed %s step for bucket %d", self.model_name, b)

    def _to_device(self, canvas: np.ndarray, sizes: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(canvas)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(sizes)).to(self.device),
        )

    # -- public -------------------------------------------------------------
    def predict_staged_async(self, canvas: np.ndarray, sizes: np.ndarray):
        """Pad to the batch bucket, copy to the device and enqueue the step
        WITHOUT waiting for it; returns a zero-arg resolver that fetches the
        results (blocking) and records step telemetry."""
        n = canvas.shape[0]
        canvas, sizes, bucket = self._pad(canvas, sizes)
        t0 = time.perf_counter()
        idx, scores = self._step(*self._to_device(canvas, sizes))
        shape_key = (bucket, canvas.shape[1])

        def resolve() -> tuple[np.ndarray, np.ndarray]:
            i = idx.cpu().numpy()[:n]
            s = scores.cpu().numpy()[:n]
            self._record_step(shape_key, (time.perf_counter() - t0) * 1000, n)
            return i, s

        return resolve

    def predict_staged(self, canvas: np.ndarray, sizes: np.ndarray):
        """canvas uint8 [N<=bucket, C, C, 3] -> (top_idx, top_scores) [N, K]."""
        return self.predict_staged_async(canvas, sizes)()

    def status(self) -> dict:
        cuda = self.device.type == "cuda"
        return {
            "enabled": True,
            "model": self.model_name,
            "precision": self.precision,
            "buckets": list(self.buckets),
            "backend": self.device.type,
            "device_name": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "devices": torch.cuda.device_count() if cuda else 1,
            "kernel_launches": launch_counts(),
            **self._stats,
        }
