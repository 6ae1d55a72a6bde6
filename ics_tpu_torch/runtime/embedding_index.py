"""In-memory embedding index with a cosine top-k on the device (counterpart
of ``ics_tpu/runtime/embedding_index.py``).

The corpus matrix lives on the device in bf16 (rows L2-normalized, so
cosine = dot). Row counts are padded to power-of-two buckets from 128, as in
the reference; the cache refreshes when the (count, latest write) version
key changes.

A search is the reference's function in PyTorch ops (the reference computes
it with XLA, outside any Pallas kernel):

- the query rounded to bf16, then each score the fp32 sum of exact bf16 x
  bf16 products, as ``jnp.dot(..., preferred_element_type=f32)`` gives it
  (the rows are widened to fp32 a slice at a time; TF32 stays off, as
  ``disable_tf32`` sets it). ``torch.mv`` on bf16 would round the scores to
  bf16, which reorders near-equal neighbours and moves the
  ``TPU_DUPLICATE_THRESHOLD`` comparisons;
- padding rows masked to -inf before the top-k;
- the top ``K_MAX`` by a stable descending sort, so that equal scores come
  lower index first, as ``jax.lax.top_k`` orders them (``torch.topk`` on
  CUDA does not promise an order among ties); sliced on the host.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from ics_tpu_torch import disable_tf32, get_device
from ics_tpu_torch.crud import embedding_crud

logger = logging.getLogger(__name__)

MIN_ROWS_BUCKET = 128
SCORE_ROWS = 1 << 16  # rows widened to fp32 at a time


def _rows_bucket(n: int) -> int:
    b = MIN_ROWS_BUCKET
    while b < n:
        b *= 2
    return b


@torch.inference_mode()
def cosine_topk(query: torch.Tensor, matrix: torch.Tensor, n_valid: int, k: int):
    """query [D] fp32, matrix [Nb, D] bf16 (rows L2-normed) -> (scores, idx)
    of the top ``k`` rows among the first ``n_valid``, best first, equal
    scores lower index first. Padding rows are masked to -inf BEFORE the
    top-k: their raw score is 0, which outranks every real match with a
    negative cosine, so with a small corpus in a large bucket the top-k would
    otherwise fill with padding and valid results silently vanish."""
    q = query.to(matrix.dtype).float()
    scores = torch.empty(matrix.shape[0], dtype=torch.float32, device=matrix.device)
    for start in range(0, matrix.shape[0], SCORE_ROWS):
        rows = matrix[start:start + SCORE_ROWS].float()
        torch.mv(rows, q, out=scores[start:start + rows.shape[0]])
    scores[n_valid:] = float("-inf")
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


class EmbeddingIndex:
    """Per-model corpus index shared by the similarity endpoints."""

    K_MAX = 64

    def __init__(self, db, modelo: str, device=None):
        self.db = db
        self.modelo = modelo
        self.device = get_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self._lock = threading.Lock()
        self._version: Optional[tuple] = None
        self._hashes: list[str] = []
        self._matrix: Optional[torch.Tensor] = None  # [Nb, D] bf16 on the device
        self._n = 0

    def refresh(self) -> None:
        with self.db.session() as s:
            version = embedding_crud.versao_corpus(s, self.modelo)
            if version == self._version:
                return
            hashes, mat = embedding_crud.carregar_corpus(s, self.modelo)
        with self._lock:
            self._version = version
            self._hashes = hashes
            self._n = len(hashes)
            if self._n == 0:
                self._matrix = None
                return
            bucket = _rows_bucket(self._n)
            padded = np.zeros((bucket, mat.shape[1]), np.float32)
            padded[: self._n] = mat.astype(np.float32)
            # bf16 on the device: the fp16 storage already bounds the
            # quantization error
            self._matrix = torch.from_numpy(padded).to(self.device, torch.bfloat16)
            logger.info(
                "embedding index (%s): %d vectors (bucket %d, dim %d)",
                self.modelo, self._n, bucket, mat.shape[1],
            )

    def search(
        self,
        query: np.ndarray,
        k: int = 10,
        exclude: Optional[str] = None,
        min_score: Optional[float] = None,
    ) -> list[dict]:
        """L2-normalized query [D] -> [{content_hash, score}] best-first."""
        from ics_tpu_torch.utils.metrics import registry as metrics_registry

        self.refresh()
        # snapshot under the lock: searches run on executor threads while
        # another thread's refresh() swaps matrix/hashes/n; indices from the
        # old matrix mapped through the new hashes would name wrong images
        with self._lock:
            matrix, hashes, n = self._matrix, self._hashes, self._n
        metrics_registry.counter(
            "similarity_searches_total", "embedding cosine top-k searches"
        ).inc()
        metrics_registry.gauge(
            "embedding_index_vectors", "vectors in the similarity index"
        ).set(n)
        if n == 0 or matrix is None:
            return []
        # always K_MAX from the device, sliced on the host, whatever k asks
        k_eff = min(self.K_MAX, int(matrix.shape[0]))
        q = torch.from_numpy(np.asarray(query, np.float32)).to(matrix.device)
        scores, idx = cosine_topk(q, matrix, n, k_eff)
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        out = []
        for i, sc in zip(idx, scores):
            if i >= n:  # padding row
                continue
            h = hashes[int(i)]
            if exclude is not None and h == exclude:
                continue
            if min_score is not None and float(sc) < min_score:
                continue
            out.append({"content_hash": h, "score": float(sc)})
            if len(out) >= k:
                break
        return out
