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

The TTA step (``predict_staged_tta``): the preprocessed batch and its
horizontal flip in one forward on 2N rows, the two probabilities averaged,
top-k. The explain step (``explain_staged``): ``d sum(logit_c) / d x`` with
respect to the preprocessed input of one image (SmoothGrad: over ``n``
noisy copies, copy 0 clean), the class chosen from the clean row and held
constant, the channel max-abs averaged over the copies, resized to
``EXPLAIN_GRID`` squared with the triangle weights of ``ops.preproc`` (the
antialiased linear resize of ``jax.image.resize``), min-max normalised.
Serving runs under ``torch.inference_mode``, where autograd cannot run, so
the explain step leaves it and differentiates with grad mode on; the folded
model's parameters require no grad (set at build time), so the gradient is
taken with respect to the input alone, as the reference's is, and the
kernels' backward passes carry it (``ops.depthwise``,
``ops.window_attention``). A model whose path runs a kernel with no backward
(ViT's flash attention, ResNet's fused chains) raises
``ops.KernelHasNoGradient``. Both steps take the lane ``_step`` takes (the
fixed-size lane where it applies) and record their steps under the
reference's keys, ``("tta", bucket, canvas)`` and ``("explain", n, canvas)``.

The engine is driven from several threads at once (the batchers' flushes,
the embed calls, the lanes' background warm-up): its step records and the
steps it makes on first use are kept under a lock.

Step time (``StepClock``): on the card, two CUDA events on the current
stream of the engine's device (the first position's under a mesh), one
before the batch's copy and one, after its top-k, as a served flush's
resolver starts its fetch, read once the step is fetched; on the CPU the
host clock at the same two points. Every lane enqueues on that one stream,
so one step's interval can hold another's work: a step is credited only
the part of its interval that no step timed before it covered, and the
credits add up to the stream time spent inside some step, each moment
once. A shape's first call (its compile) and
``record=False`` (warm-up) stay out of ``device_ms``, as out of the
registry's ``step_device_ms`` histogram and ``resolved_images`` counter.
A served flush (``predict_staged_async``, ``predict_coeff_staged_async``)
is timed in spans (``utils.metrics``): ``pad`` to the bucket (the pixel
lane), ``copy`` of the padded host arrays to the device (the counter
``copy_bytes`` adds their bytes, ``dispatched_images`` the flush's real
images; under a mesh the copies run inside ``launch``), and ``launch``, the
step's enqueue.

The coefficient lanes stage at the bucket (``stage_coefficients``): each
lane has a few host slots (``device_decode.StagingPool``), made with rows
for the largest bucket its warm-up runs and page-locked on a card, and a
flush holds one from its staging until its resolver has returned
(``release_staged``). Its copy is then enqueued without blocking (counted in
``pinned_flushes``), and nothing from staging to the launch's return waits
for the stream: a lane's dispatch does not wait for the step before it, nor
for the other lane's copy.

On a mesh (``mesh``, ``parallel.mesh``): a ``("data"[, "model"])`` mesh of
more than one position serves the pixel, coefficient and embed steps data
parallel (``parallel.mesh.MeshModel``: the batch split over the ``data``
positions, the head split by classes over ``model`` where the class count
divides), every bucket rounded up to a multiple of the ``data`` axis; the
TTA and explain steps run the whole batch on the first position, as the
reference runs them in one unsharded program. A one-position mesh pins the
engine to its device. A ``("pp",)`` mesh serves a ViT-family model through
the GPipe pipeline (``parallel.pipeline``) with ``pp_microbatches``
microbatches, every bucket rounded up to whole microbatches; the
coefficient, TTA, explain and embed steps then raise ``RuntimeError``, as
the reference's do. The kernels' launch counts (``ops.LAUNCHES``) are the
process's: a data-parallel step launches each kernel once a position.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from bisect import bisect_left
from typing import Optional, Sequence

import numpy as np
import torch

from ics_tpu_torch import disable_tf32, get_device
from ics_tpu_torch.models.registry import ModelSpec, get_model
from ics_tpu_torch.ops import launch_counts
from ics_tpu_torch.ops.normalize import normalize_u8
from ics_tpu_torch.ops.preproc import _triangle_weights, preprocess_batch
from ics_tpu_torch.parallel.mesh import MeshModel, headless
from ics_tpu_torch.parallel.pipeline import pipeline_vit_forward, stage_block_params
from ics_tpu_torch.runtime.device_decode import (
    STAGED_KEYS,
    StagedBatch,
    StagingPool,
    make_fused_decode_infer_step,
    pad_staged,
    stage_coefficient_batch,
    to_device,
)
from ics_tpu_torch.utils.metrics import registry, span

logger = logging.getLogger(__name__)

TOP_K = 5
PAD_SIZE = 256  # true (h, w) given to padding rows: any sane extent will do
EXPLAIN_GRID = 16  # side of the saliency grid explain returns, whatever the image size
_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


_NO_SPAN = contextlib.nullcontext()
PINNED_FLUSHES = ("pinned_flushes",
                  "flushes copied from a page-locked staging slot without blocking")


class StepClock:
    """Marks on a step's clock and the stream time the timed steps cover.

    ``mark`` is a CUDA event recorded on the current stream of the device
    (the host clock, in ms, on the CPU); ``credit(start, end)`` places the
    two marks of a finished step on one timeline and returns the part of
    [start, end] that no step credited before covered, so the credits add
    up to the union of the steps' intervals. The timeline's origin is an
    event of its own, moved to a newer step's start every ``REBASE_MS``
    (``elapsed_time`` is a float32 of ms: 0.06 ms apart at 10 min).

    The events are kept for reuse: while another thread copies from pageable
    memory every CUDA call waits for that copy, so an event made and
    destroyed a step (the last reference often dropped on the event loop)
    would add such waits.
    """

    REBASE_MS = 600_000.0
    HORIZON_MS = 60_000.0       # no step lasts longer: older cover is forgotten

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._lock = threading.Lock()
        self._events: list = []
        self._origin = None     # (event, its time on the timeline, ms)
        self._covered: list = []    # disjoint (start, end) ms, ascending

    def mark(self):
        if not self.cuda:
            return time.perf_counter() * 1e3
        stream = torch.cuda.current_stream(self.device)
        if self._origin is None:
            with self._lock:                    # recorded before any mark it times
                if self._origin is None:
                    origin = torch.cuda.Event(enable_timing=True)
                    origin.record(stream)
                    self._origin = (origin, 0.0)
        try:
            event = self._events.pop()
        except IndexError:
            event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def release(self, start, end) -> None:
        """Hand back the marks of a step that is not timed."""
        if self.cuda:
            self._events += (start, end)

    def credit(self, start, end) -> float:
        """ms of [start, end] (two marks of a fetched step) that no step
        credited before covered."""
        if self.cuda:
            origin, at = self._origin
            offset = origin.elapsed_time(start)
            lo = at + offset
            hi = lo + start.elapsed_time(end)
        else:
            lo, hi = start, end
        with self._lock:
            ms = self._cover(lo, hi)
            if self.cuda and offset > self.REBASE_MS and self._origin[0] is origin:
                self._origin, start = (start, lo), None     # the new origin stays out of reuse
        if self.cuda:
            self._events += [e for e in (start, end) if e is not None]
        return ms

    def _cover(self, lo: float, hi: float) -> float:
        cov = self._covered
        i = bisect_left(cov, (lo,))
        if i and cov[i - 1][1] >= lo:
            i -= 1
        j, new, a0, b0 = i, hi - lo, lo, hi
        while j < len(cov) and cov[j][0] <= hi:
            a, b = cov[j]
            new -= min(b, hi) - max(a, lo)
            a0, b0 = min(a0, a), max(b0, b)
            j += 1
        cov[i:j] = [(a0, b0)]
        stale = bisect_left(cov, (cov[-1][1] - self.HORIZON_MS,))
        if stale > 1:
            del cov[:stale - 1]
        return new


def _resize_linear(heat: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W] fp32 -> [size, size]: ``jax.image.resize(..., "linear")``, which
    widens its triangle by the shrink factor, as two products with the
    triangle weights of ``ops.preproc`` (those of PIL's BILINEAR)."""
    h, w = heat.shape

    def weights(n: int) -> torch.Tensor:
        one = lambda v: torch.tensor([float(v)], dtype=torch.float32, device=heat.device)
        return _triangle_weights(n, size, one(n), one(n) / size, one(0))[0]

    return weights(h) @ heat @ weights(w).T


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
        mesh=None,
        pp_microbatches: int = 4,
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
        axes = getattr(mesh, "axis_names", ())
        if "data" in axes:
            # sharded serving: every bucket must divide over the data axis
            data_size = int(mesh.shape["data"])
            buckets = {max(((b + data_size - 1) // data_size) * data_size, data_size)
                       for b in buckets}
        model = self.spec.build(num_classes=num_classes)
        # pipeline-parallel serving (TPU_PP_STAGES -> ('pp',) mesh): the
        # transformer trunk is split across the pp positions and microbatches
        # flow stage to stage. ViT family only: the schedule needs a
        # homogeneous trunk of blocks.
        self.pp_microbatches = 0
        if "pp" in axes:
            stages = int(mesh.shape["pp"])
            blocks = getattr(model, "blocks", None)
            if not (blocks and hasattr(model, "patch_embed") and hasattr(model, "ln")):
                raise ValueError(
                    f"TPU_PP_STAGES: modelo {model_name!r} não tem tronco "
                    "transformer homogêneo (família ViT) — pipeline "
                    "parallelism não se aplica"
                )
            depth = len(blocks)
            if depth % stages:
                raise ValueError(
                    f"TPU_PP_STAGES={stages} não divide a profundidade "
                    f"{depth} de {model_name!r}"
                )
            m = max(1, int(pp_microbatches))
            self.pp_microbatches = m
            # every bucket must split into whole microbatches
            buckets = {max(((b + m - 1) // m) * m, m) for b in buckets}
        self.buckets = tuple(sorted(set(buckets)))
        self.canvas = canvas
        self.mesh = mesh
        if mesh is not None:
            # a mesh-pinned engine lives on its first position's device
            first = get_device(mesh.devices.flat[0])
            if device is not None and get_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        self.device = get_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        # weights are drawn on the CPU from the seed, so one seed gives the
        # same model on every device, then cast (every fp32 tensor, as the
        # JAX engine casts every fp32 leaf) and moved
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
        # serving needs no parameter gradient: the explain step differentiates
        # with respect to the input alone
        self._mesh_model: Optional[MeshModel] = None
        self._stages = None
        if mesh is not None and not self.pp_microbatches and mesh.size > 1:
            self._mesh_model = MeshModel(mesh, folded, self.dtype)
            self.model = self._mesh_model.groups[0].model
        else:
            self.model = folded.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        if self.pp_microbatches:
            # the trunk's blocks placed on their stages' devices once, here
            self._stages = stage_block_params(list(self.model.blocks), mesh)
        self.fused_chains = fused_chains
        self._compiled_shapes: set = set()
        self._coeff_steps: dict = {}
        self._staging_pools: dict = {}
        self._embed_model: Optional[torch.nn.Module] = None
        # guards _compiled_shapes, _stats and the steps and pools made on first use
        self._lock = threading.Lock()
        self._stats = {
            "batches": 0, "images": 0, "device_ms": 0.0, "compiles": 0,
        }
        self._clock = StepClock(self.device)
        self._mark = self._clock.mark
        registry.counter(*PINNED_FLUSHES)       # from 0, also where no slot is page-locked

    @staticmethod
    def _span(name: str, record: bool = True, **args):
        """A span of a served flush; warm-ups (``record=False``) time none."""
        return span(name, **args) if record else _NO_SPAN

    @staticmethod
    def _count_dispatch(n: int, arrays) -> None:
        registry.counter("dispatched_images", "real images of the dispatched flushes").inc(n)
        registry.counter("copy_bytes", "bytes copied host to device by the flushes").inc(
            sum(a.nbytes for a in arrays))

    def _record_step(self, key, n: int, marks=None, record: bool = True) -> None:
        """The FIRST call on a shape key is a compile (counted, kept out of
        device_ms); ``record=False`` keeps warmup out of the stats. ``marks``
        (the step's two ``_mark``s) go back to the clock, read only where the
        step is timed."""
        with self._lock:
            new_shape = key not in self._compiled_shapes
            self._compiled_shapes.add(key)
            if record:
                self._stats["batches"] += 1
                self._stats["images"] += n
                self._stats["compiles"] += new_shape
        if marks is None:
            return
        if not record or new_shape:
            self._clock.release(*marks)
            return
        ms = self._clock.credit(*marks)
        with self._lock:
            self._stats["device_ms"] += ms
        registry.histogram("step_device_ms", "a step's stream time no step before it "
                           "covered (ms)").observe(ms)
        registry.counter("resolved_images", "real images of the timed steps").inc(n)

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

    def _preprocess(self, canvas: torch.Tensor, sizes: torch.Tensor,
                    fixed_size: bool) -> torch.Tensor:
        s = self.spec.image_size
        if fixed_size:
            return normalize_u8(canvas[:, :s, :s], dtype=self.dtype)
        return preprocess_batch(
            canvas, sizes, out_size=s,
            resize_short=self.spec.resize_short, dtype=self.dtype,
        )

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(logits) if self.multi_label else torch.softmax(logits, dim=-1)

    def _top(self, logits: torch.Tensor):
        scores, idx = torch.topk(self._probs(logits.float()), self._top_k(), dim=-1)
        return idx, scores

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of a preprocessed batch on the engine's device: the
        pipeline under PP, else the folded model (the first position's copy)."""
        if self._stages is not None:
            return pipeline_vit_forward(self.model, x, self.mesh, self.pp_microbatches,
                                        use_flash=True, stages=self._stages)
        return self.model.apply_folded(x)

    @torch.inference_mode()
    def _step(self, canvas: torch.Tensor, sizes: torch.Tensor, fixed_size: bool = False):
        """The classify step of a batch already on the engine's device, on
        the engine's device alone (pipelined under PP)."""
        return self._top(self._forward(self._preprocess(canvas, sizes, fixed_size)))

    @torch.inference_mode()
    def _dispatch(self, canvas: np.ndarray, sizes: np.ndarray, fixed_size: bool = False):
        """Enqueue the classify step of a padded host batch: over the mesh's
        data groups where there is a mesh, else on the engine's device.
        Returns (idx, scores) on the engine's device without waiting."""
        if self._mesh_model is None:
            return self._step(*self._to_device(canvas, sizes), fixed_size=fixed_size)
        return self._mesh_model.map(
            lambda group, c, s: self._top(group.apply_folded(self._preprocess(c, s, fixed_size))),
            canvas, sizes)

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
            self._dispatch(canvas, sizes)[0].cpu()
            self._record_step((b, self.canvas), b, record=False)
            if self.spec.resize_short == self.spec.image_size <= self.canvas:
                self._dispatch(canvas, sizes, fixed_size=True)[0].cpu()
                self._record_step((b, self.canvas, "fixed"), b, record=False)
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
        with self._span("pad"):
            canvas, sizes, bucket = self._pad(canvas, sizes)
        self._count_dispatch(n, (canvas, sizes))
        start = self._mark()
        if self._mesh_model is None:
            with self._span("copy"):
                dev = self._to_device(canvas, sizes)
            with self._span("launch", bucket=bucket):
                idx, scores = self._step(*dev, fixed_size=fixed_size)
        else:
            with self._span("launch", bucket=bucket):   # each data group copies its rows
                idx, scores = self._dispatch(canvas, sizes, fixed_size)
        shape_key = (bucket, canvas.shape[1]) + (("fixed",) if fixed_size else ())

        def resolve() -> tuple[np.ndarray, np.ndarray]:
            # each mark and read sits next to a CUDA call the flush makes
            # anyway (the copy, the two fetches), so a wait behind another
            # thread's pageable copy falls where the flush waited already
            end = self._mark()
            i = idx.cpu().numpy()[:n]
            self._record_step(shape_key, n, (start, end))
            s = scores.cpu().numpy()[:n]
            return i, s

        return resolve

    def predict_staged(self, canvas: np.ndarray, sizes: np.ndarray):
        """canvas uint8 [N<=bucket, C, C, 3] -> (top_idx, top_scores) [N, K]."""
        return self.predict_staged_async(canvas, sizes)()

    def _require_no_pp(self, what: str) -> None:
        """The TTA, explain and embed steps run the whole trunk on one
        device: under pipeline parallelism the model by premise does not fit
        one stage, so they refuse instead (as the coefficient step does)."""
        if self.pp_microbatches:
            raise RuntimeError(
                f"{what} indisponível com pipeline parallelism "
                "(TPU_PP_STAGES) — o passo roda o tronco inteiro "
                "não-pipelinado em um device"
            )

    # -- test-time augmentation ----------------------------------------------
    @torch.inference_mode()
    def _tta_step(self, canvas: torch.Tensor, sizes: torch.Tensor, fixed_size: bool = False):
        """Probabilities averaged over the image and its horizontal flip: the
        flip of the preprocessed batch (the width axis of NHWC), one forward
        on 2N rows."""
        x = self._preprocess(canvas, sizes, fixed_size)
        probs = self._probs(self.model.apply_folded(torch.cat([x, x.flip(2)])).float())
        n = x.shape[0]
        probs = (probs[:n] + probs[n:]) * 0.5
        scores, idx = torch.topk(probs, self._top_k(), dim=-1)
        return idx, scores

    def predict_staged_tta(self, canvas: np.ndarray, sizes: np.ndarray):
        """Flip-averaged twin of ``predict_staged`` (twice the device work for
        steadier scores; asked for per request): canvas uint8 [N<=bucket, C,
        C, 3] -> (top_idx, top_scores) [N, K]."""
        self._require_no_pp("TTA")
        n = canvas.shape[0]
        fixed_size = self._fixed_size(canvas, sizes)
        canvas, sizes, bucket = self._pad(canvas, sizes)
        start = self._mark()
        idx, scores = self._tta_step(*self._to_device(canvas, sizes), fixed_size=fixed_size)
        end = self._mark()
        idx, scores = idx.cpu().numpy()[:n], scores.cpu().numpy()[:n]
        self._record_step(("tta", bucket, canvas.shape[1]), n, (start, end))
        return idx, scores

    # -- explainability ------------------------------------------------------
    # SmoothGrad sample counts served: the request's count is quantized up
    # into this set, as the reference's one compiled graph per value
    EXPLAIN_SMOOTH_BUCKETS = (1, 4, 8, 16)

    @classmethod
    def quantize_smooth(cls, n: int) -> int:
        """The one place the sample-count rule lives: the first bucket at or
        above ``n``, the largest past them all."""
        for b in cls.EXPLAIN_SMOOTH_BUCKETS:
            if n <= b:
                return b
        return cls.EXPLAIN_SMOOTH_BUCKETS[-1]

    def _explain_step(self, canvas: torch.Tensor, sizes: torch.Tensor, class_idx: int,
                      n: int, seed: int, fixed_size: bool):
        """Forward and input gradient of one image (row 0) over ``n`` copies;
        returns (top_idx [K], top_scores [K], heat [G, G]) on the device."""
        with torch.inference_mode(False), torch.enable_grad():
            x0 = self._preprocess(canvas[:1], sizes[:1], fixed_size)[0]
            if n == 1:
                xs = x0[None]
            else:
                # sigma = 10 % of the image's span; the noise is drawn on the
                # CPU from its own generator, so every device draws the same
                span = (x0.max() - x0.min()).float()
                noise = torch.randn((n, *x0.shape), dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(seed))
                noise = (0.1 * span) * noise.to(x0.device)
                noise[0] = 0.0                        # the clean copy: the top-k's source
                xs = x0[None] + noise.to(x0.dtype)
            xs = xs.detach().requires_grad_()
            logits = self.model.apply_folded(xs).float()
            clean = logits[0].detach()
            if class_idx >= 0:
                cls = torch.tensor([min(class_idx, clean.shape[0] - 1)], device=clean.device)
            else:
                cls = clean.argmax().view(1)
            # the sum over copies: one backward gives each copy its own gradient
            (grad,) = torch.autograd.grad(logits.index_select(1, cls).sum(), xs)
        heat = grad.float().abs().amax(dim=-1).mean(dim=0)          # [H, W]
        heat = _resize_linear(heat, EXPLAIN_GRID)
        lo, hi = heat.min(), heat.max()
        heat = (heat - lo) / (hi - lo).clamp_min(1e-12)
        scores, idx = torch.topk(self._probs(clean), self._top_k())
        return idx, scores, heat

    def explain_staged(self, canvas: np.ndarray, sizes: np.ndarray, class_idx: int = -1,
                       smooth_samples: int = 1, seed: int = 0):
        """One image (row 0) -> (top_idx [K], top_scores [K], heat [G, G]):
        the saliency of class ``class_idx`` (the model's own top class when
        negative; clipped to the last class) as |d logit / d x| over the
        preprocessed input, its channels reduced by max-abs, on a G x G grid
        in [0, 1]. ``smooth_samples`` quantizes up into
        ``EXPLAIN_SMOOTH_BUCKETS``; above 1 it is SmoothGrad over that many
        copies with noise drawn from ``seed``."""
        self._require_no_pp("explicar (saliência)")
        n = self.quantize_smooth(smooth_samples)
        canvas, sizes = canvas[:1], sizes[:1]
        fixed_size = self._fixed_size(canvas, sizes)
        start = self._mark()
        idx, scores, heat = self._explain_step(*self._to_device(canvas, sizes), class_idx, n,
                                               seed, fixed_size)
        end = self._mark()
        out = idx.cpu().numpy(), scores.cpu().numpy(), heat.cpu().numpy()
        self._record_step(("explain", n, canvas.shape[1]), 1, (start, end))
        return out

    # -- the JPEG-coefficient (device decode) lanes ---------------------------
    def _get_coeff_step(self, mode: str = "420"):
        """The fused decode step of one sampling mode (coefficients in, top-k
        out), made on first use; over the mesh's data groups where there is
        a mesh. Under PP it raises: the lanes would run the trunk unpipelined,
        so the service decodes on the host instead."""
        if self.pp_microbatches:
            raise RuntimeError(
                "decode-on-TPU indisponível com pipeline parallelism "
                "(TPU_PP_STAGES) — o serviço usa decode no host"
            )
        with self._lock:
            step = self._coeff_steps.get(mode)
            if step is None:
                step = make_fused_decode_infer_step(
                    self.model, self.spec, dtype=self.dtype, top_k=self._top_k(),
                    mode=mode, multi_label=self.multi_label, mesh=self._mesh_model,
                )
                self._coeff_steps[mode] = step
            return step

    def _staging(self, mode: str, luma_blocks: int) -> StagingPool:
        """The host staging slots of one coefficient lane, made on first use:
        page-locked on a card."""
        with self._lock:
            pool = self._staging_pools.get((mode, luma_blocks))
            if pool is None:
                pool = StagingPool(mode, luma_blocks, pin=self.device.type == "cuda")
                self._staging_pools[(mode, luma_blocks)] = pool
            return pool

    def stage_coefficients(self, coeff_list: Sequence, mode: str,
                           luma_blocks: int) -> Optional[StagedBatch]:
        """Stage a flush of one coefficient lane into one of the lane's
        reused host slots, padded to its batch bucket. The slot is the
        caller's until it hands the batch back with ``release_staged``,
        once the flush's resolver has returned. None (the slot handed back
        already) where the batch does not fit the lane."""
        n = len(coeff_list)
        rows = max(n, self.bucket_for(n))
        pool = self._staging(mode, luma_blocks)
        slot = pool.acquire(rows)
        staged = stage_coefficient_batch(coeff_list, luma_blocks, mode, slot=slot, rows=rows)
        if staged is None:
            pool.release(slot)
        return staged

    def release_staged(self, staged) -> None:
        """Hand a staged batch's slot back to its lane (a plain batch has none)."""
        slot = getattr(staged, "slot", None)
        if slot is not None:
            self._staging(slot.mode, slot.luma_blocks).release(slot)

    def predict_coeff_staged_async(self, staged: dict, mode: str = "420",
                                   record: bool = True):
        """Copy a staged coefficient batch (``runtime.device_decode``), padded
        to the batch bucket, to the device and enqueue the step WITHOUT
        waiting; returns a zero-arg resolver, as ``predict_staged_async``.
        A batch staged in a slot at its bucket (``stage_coefficients``) is
        copied from the slot's page-locked rows without blocking; any other
        is padded into new arrays and copied as it is."""
        n = staged["y"].shape[0]
        bucket = self.bucket_for(n)
        slot = getattr(staged, "slot", None)
        if slot is not None and slot.staged_rows == max(n, bucket):
            arrays = {k: slot.tensors[k][:slot.staged_rows] for k in STAGED_KEYS}
            pinned = slot.pin
        else:
            arrays, pinned = pad_staged(staged, bucket), False
        step = self._get_coeff_step(mode)
        if record:
            self._count_dispatch(n, [arrays[k] for k in STAGED_KEYS])
        start = self._mark()
        if self._mesh_model is None:
            with self._span("copy", record):
                dev = to_device(arrays, self.device, non_blocking=pinned)
                if pinned:
                    slot.event.record(torch.cuda.current_stream(self.device))
            if pinned and record:
                registry.counter(*PINNED_FLUSHES).inc()
        else:
            dev = arrays                        # each data group copies its rows
        with self._span("launch", record, bucket=bucket):
            idx, scores = step(*(dev[k] for k in STAGED_KEYS))
        shape_key = ("coeff", mode, arrays["y"].shape[1], bucket)

        def resolve() -> tuple[np.ndarray, np.ndarray]:
            end = self._mark()                  # placed as the pixel lane's
            i = idx.cpu().numpy()[:n]
            self._record_step(shape_key, n, (start, end), record)
            s = scores.cpu().numpy()[:n]
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
        of the stats, so the first flush does not pay the cold start; and
        make the lane's staging slots with rows for the largest of them."""
        buckets = buckets or self.buckets
        # the lane's staging slots, page-locked here rather than in serving
        self._staging(mode, luma_blocks).reserve(max(buckets))
        for b in buckets:
            # b padding rows: zero coefficients and tables, sizes 64
            staged = pad_staged(stage_coefficient_batch([], luma_blocks, mode), b)
            self.predict_coeff_staged(staged, mode=mode, record=False)
            logger.info("warmed %s decode lane %s/%dpx for bucket %d",
                        self.model_name, mode, luma_blocks * 8, b)

    # -- embeddings ----------------------------------------------------------
    @property
    def embed_dim(self) -> int:
        """Backbone feature width = the classifier head's input width."""
        return int(self.model.head.weight.shape[1])

    def _get_embed_model(self) -> torch.nn.Module:
        """The folded model with ``head`` replaced by the identity
        (``parallel.mesh.headless``), made on first use."""
        with self._lock:
            if self._embed_model is None:
                self._embed_model = headless(self.model)
            return self._embed_model

    @torch.inference_mode()
    def _embed_step(self, trunk: torch.nn.Module, canvas: torch.Tensor,
                    sizes: torch.Tensor) -> torch.Tensor:
        x = preprocess_batch(
            canvas, sizes, out_size=self.spec.image_size,
            resize_short=self.spec.resize_short, dtype=self.dtype,
        )
        feats = trunk.apply_folded(x).float()
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats / torch.clamp(norm, min=1e-8)

    def embed_staged(self, canvas: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """canvas uint8 [N<=bucket, C, C, 3] -> L2-normalized features
        [N, D] float32 (cosine similarity = plain dot product); data
        parallel over the mesh where there is one."""
        self._require_no_pp("embeddings")
        n = canvas.shape[0]
        canvas, sizes, bucket = self._pad(canvas, sizes)
        start = self._mark()
        if self._mesh_model is None:
            feats = self._embed_step(self._get_embed_model(), *self._to_device(canvas, sizes))
        else:
            (feats,) = self._mesh_model.map(
                lambda group, c, s: (self._embed_step(group.trunk, c, s),), canvas, sizes)
        end = self._mark()
        feats = feats.cpu().numpy()[:n]
        self._record_step(("embed", bucket, canvas.shape[1]), n, (start, end))
        return feats

    def status(self) -> dict:
        cuda = self.device.type == "cuda"
        with self._lock:
            stats = dict(self._stats)
        timed = stats["batches"] - stats["compiles"]
        return {
            "enabled": True,
            "model": self.model_name,
            "precision": self.precision,
            "buckets": list(self.buckets),
            "backend": self.device.type,
            "device_name": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            # a mesh-pinned engine (a hedged replica's too) reports its
            # mesh's size, not the host's device count
            "devices": (self.mesh.size if self.mesh is not None
                        else torch.cuda.device_count() if cuda else 1),
            "fused_chains": self.fused_chains,
            "kernel_launches": launch_counts(),
            **stats,
            "avg_device_ms": stats["device_ms"] / timed if timed else None,
            "device_clock": "cuda_events" if cuda else "host",
        }
