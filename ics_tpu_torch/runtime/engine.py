"""Inference engine for the pixel lane (counterpart of ``ics_tpu/runtime/engine.py``).

One step per batch bucket: uint8 canvas -> fp32 resize/crop/normalize on
the device -> forward in the serving dtype (ViT attention in the flash
kernel; ResNet bottleneck chains in the fused kernel when ``fused_chains``;
the stride-1 depthwise convolutions of ConvNeXt, MobileNetV3 and
EfficientNet in the depthwise kernel; Swin's window attention in its
kernel) -> softmax (or sigmoid when multi-label) and top-k. Requests are padded up
to the nearest bucket, so the device sees a small fixed set of shapes.
PyTorch runs eagerly: the first call on a shape pays the kernel builds and
cuBLAS/cuDNN plan selection, and is counted as the compile.

The fixed-size lane: for a model whose ``resize_short == image_size``, a
batch whose real images are all exactly ``image_size`` square needs no
resize (the triangle weights are the identity), so the step normalizes the
top-left window of the canvas with the ``normalize_u8`` kernel and skips
the two resize matmuls.

The JPEG-coefficient step (``predict_coeff_staged``): entropy-decoded
coefficients staged on a block canvas per (sampling mode, luma bucket) ->
device decode (``runtime.device_decode``) -> the resize path on the fp32
canvas -> the same forward and top-k. One step per sampling mode; the shape
key ``("coeff", mode, luma_blocks, bucket)`` counts its first call as the
compile.

The embed step (``embed_staged``): the same folded model with its
classifier head skipped (``_embed_model``, a shallow copy whose ``head`` is
``nn.Identity`` and which shares every other module, so a classify on
another thread is untouched). The features come out of the trunk in the
serving dtype, which is what the reference's identity head returns: a bf16
matmul by the identity rounds nothing further. Then ``float32`` and
``feats / max(||feats||, 1e-8)``. With ``fused_chains`` the embed step
runs the chain kernel as the classify step does.

The engine is driven from several threads at once (the batchers' flushes,
the embed calls, the lanes' background warm-up): its step records and the
steps it makes on first use are kept under a lock.

Not ported yet: the mesh, pipeline-parallel, TTA and explain lanes.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ics_tpu_torch import disable_tf32, get_device
from ics_tpu_torch.models.registry import ModelSpec, get_model
from ics_tpu_torch.ops import launch_counts
from ics_tpu_torch.ops.normalize import normalize_u8
from ics_tpu_torch.ops.preproc import preprocess_batch
from ics_tpu_torch.runtime.device_decode import (
    STAGED_KEYS,
    _chroma_canvas,
    make_fused_decode_infer_step,
    to_device,
)

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
        fused_chains: bool = False,
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
        # fused_chains is a deployment-wide setting: it reaches fold() of the
        # models that fold can chain (dense-bottleneck ResNets) and is off for
        # every other model, basic-block, grouped and wide ResNets included
        fused_chains = bool(fused_chains) and bool(getattr(model, "can_fuse_chains", False))
        if fused_chains and self.device.type == "cuda" and precision != "bf16":
            raise ValueError("fused_chains on the GPU needs precision='bf16': "
                             "the bottleneck_chain kernel takes bf16 activations")
        folded = model.fold(fused_chains=True) if fused_chains else model.fold()
        self.model = folded.to(device=self.device, dtype=self.dtype).eval()
        self.fused_chains = fused_chains
        self._compiled_shapes: set = set()
        self._coeff_steps: dict = {}
        self._embed_model: Optional[torch.nn.Module] = None
        # guards _compiled_shapes, _stats and the steps made on first use
        self._lock = threading.Lock()
        self._stats = {
            "batches": 0, "images": 0, "total_device_ms": 0.0, "compiles": 0,
        }

    def _record_step(self, key, dt_ms: float, n: int, record: bool = True) -> None:
        """The FIRST call on a shape key is a compile (counted, kept out of
        total_device_ms); ``record=False`` keeps warmup out of the stats."""
        with self._lock:
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

    def _fixed_size(self, canvas: np.ndarray, sizes: np.ndarray) -> bool:
        """Whether a batch takes the fixed-size lane: the model resizes to
        its own input size, the canvas holds that window, and every real
        image (padding rows do not count) is exactly that size."""
        s = self.spec.image_size
        return (
            self.spec.resize_short == s
            and len(sizes) > 0
            and min(canvas.shape[1], canvas.shape[2]) >= s
            and bool((np.asarray(sizes) == s).all())
        )

    @torch.inference_mode()
    def _step(self, canvas: torch.Tensor, sizes: torch.Tensor, fixed_size: bool = False):
        s = self.spec.image_size
        if fixed_size:
            x = normalize_u8(canvas[:, :s, :s], dtype=self.dtype)
        else:
            x = preprocess_batch(
                canvas, sizes, out_size=s,
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
            staged = self._to_device(canvas, sizes)
            idx, _ = self._step(*staged)
            idx.cpu()
            self._record_step((b, self.canvas), 0.0, b, record=False)
            if self.spec.resize_short == self.spec.image_size <= self.canvas:
                idx, _ = self._step(*staged, fixed_size=True)
                idx.cpu()
                self._record_step((b, self.canvas, "fixed"), 0.0, b, record=False)
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
        fixed_size = self._fixed_size(canvas, sizes)
        canvas, sizes, bucket = self._pad(canvas, sizes)
        t0 = time.perf_counter()
        idx, scores = self._step(*self._to_device(canvas, sizes), fixed_size=fixed_size)
        shape_key = (bucket, canvas.shape[1]) + (("fixed",) if fixed_size else ())

        def resolve() -> tuple[np.ndarray, np.ndarray]:
            i = idx.cpu().numpy()[:n]
            s = scores.cpu().numpy()[:n]
            self._record_step(shape_key, (time.perf_counter() - t0) * 1000, n)
            return i, s

        return resolve

    def predict_staged(self, canvas: np.ndarray, sizes: np.ndarray):
        """canvas uint8 [N<=bucket, C, C, 3] -> (top_idx, top_scores) [N, K]."""
        return self.predict_staged_async(canvas, sizes)()

    # -- the JPEG-coefficient (device decode) lanes ---------------------------
    def _get_coeff_step(self, mode: str = "420"):
        """The fused decode step of one sampling mode (coefficients in, top-k
        out), made on first use."""
        with self._lock:
            step = self._coeff_steps.get(mode)
            if step is None:
                step = make_fused_decode_infer_step(
                    self.model, self.spec, dtype=self.dtype, top_k=self._top_k(),
                    mode=mode, multi_label=self.multi_label,
                )
                self._coeff_steps[mode] = step
            return step

    def predict_coeff_staged_async(self, staged: dict, mode: str = "420",
                                   record: bool = True):
        """Pad a staged coefficient batch (``runtime.device_decode``) to the
        batch bucket, copy it to the device and enqueue the step WITHOUT
        waiting; returns a zero-arg resolver, as ``predict_staged_async``."""
        n = staged["y"].shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = bucket - n
            staged = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
                      for k, v in staged.items()}
            # zero quant tables make padded rows decode to zeros; give the
            # padded sizes a sane nonzero extent for the resize plan
            staged["sizes"][n:] = 64
        step = self._get_coeff_step(mode)
        t0 = time.perf_counter()
        dev = to_device(staged, self.device)
        idx, scores = step(*(dev[k] for k in STAGED_KEYS))
        shape_key = ("coeff", mode, staged["y"].shape[1], bucket)

        def resolve() -> tuple[np.ndarray, np.ndarray]:
            i = idx.cpu().numpy()[:n]
            s = scores.cpu().numpy()[:n]
            self._record_step(shape_key, (time.perf_counter() - t0) * 1000, n, record=record)
            return i, s

        return resolve

    def predict_coeff_staged(self, staged: dict, mode: str = "420",
                             record: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """Staged coefficient batch -> (top_idx, top_scores) [N, K]."""
        return self.predict_coeff_staged_async(staged, mode, record)()

    def warmup_coeff(self, mode: str = "420", luma_blocks: int = 64,
                     buckets: Optional[Sequence[int]] = None) -> None:
        """Run the decode lane of ``mode`` at ``luma_blocks`` once per batch
        bucket (default: 4:2:0 at 512 px, the dominant JPEG shape), kept out
        of the stats, so the first flush does not pay the cold start."""
        cv, ch = _chroma_canvas(mode, luma_blocks)
        for b in buckets or self.buckets:
            staged = {
                "y": np.zeros((b, luma_blocks, luma_blocks, 64), np.int16),
                "cb": np.zeros((b, cv, ch, 64), np.int16),
                "cr": np.zeros((b, cv, ch, 64), np.int16),
                "yq": np.zeros((b, 64), np.uint16),
                "cq": np.zeros((b, 64), np.uint16),
                "rq": np.zeros((b, 64), np.uint16),
                "sizes": np.full((b, 2), 64, np.int32),
            }
            self.predict_coeff_staged(staged, mode=mode, record=False)
            logger.info("warmed %s decode lane %s/%dpx for bucket %d",
                        self.model_name, mode, luma_blocks * 8, b)

    # -- embeddings ----------------------------------------------------------
    @property
    def embed_dim(self) -> int:
        """Backbone feature width = the classifier head's input width."""
        return int(self.model.head.weight.shape[1])

    def _get_embed_model(self) -> torch.nn.Module:
        """The folded model with ``head`` replaced by the identity: a shallow
        copy that shares every parameter, buffer and module but the head.
        Every model of the zoo ends its ``apply_folded`` with
        ``self.head(feats)``, so the copy returns the penultimate features."""
        with self._lock:
            if self._embed_model is None:
                model = copy.copy(self.model)
                model._modules = dict(self.model._modules)
                model.head = torch.nn.Identity()
                self._embed_model = model
            return self._embed_model

    @torch.inference_mode()
    def _embed_step(self, canvas: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        x = preprocess_batch(
            canvas, sizes, out_size=self.spec.image_size,
            resize_short=self.spec.resize_short, dtype=self.dtype,
        )
        feats = self._get_embed_model().apply_folded(x).float()
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats / torch.clamp(norm, min=1e-8)

    def embed_staged(self, canvas: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """canvas uint8 [N<=bucket, C, C, 3] -> L2-normalized features
        [N, D] float32 (cosine similarity = plain dot product)."""
        n = canvas.shape[0]
        canvas, sizes, bucket = self._pad(canvas, sizes)
        t0 = time.perf_counter()
        feats = self._embed_step(*self._to_device(canvas, sizes)).cpu().numpy()[:n]
        self._record_step(("embed", bucket, canvas.shape[1]),
                          (time.perf_counter() - t0) * 1000, n)
        return feats

    def status(self) -> dict:
        cuda = self.device.type == "cuda"
        with self._lock:
            stats = dict(self._stats)
        return {
            "enabled": True,
            "model": self.model_name,
            "precision": self.precision,
            "buckets": list(self.buckets),
            "backend": self.device.type,
            "device_name": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "devices": torch.cuda.device_count() if cuda else 1,
            "fused_chains": self.fused_chains,
            "kernel_launches": launch_counts(),
            **stats,
        }
