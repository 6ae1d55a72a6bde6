"""Embedding CRUD: vector codec + upsert + corpus loading (net-new TPU
tier; no reference counterpart — the reference's only image identity is
the SHA-256 exact hash, ``app/api/routes/images.py:18-101``).

Vectors are L2-normalized float16, base64-encoded into a TEXT column
(portable across the sqlite and PG dialects). fp16 quantization of a
unit vector costs <1e-3 cosine error — far below any duplicate/similarity
threshold in use.
"""

from __future__ import annotations

import base64
from typing import Optional, Sequence

import numpy as np

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import EmbeddingImagem


def encode_vector(vec: np.ndarray) -> str:
    # '<f2' UNCONDITIONALLY: np.float16 is native order whose byteorder
    # reports '=' (never '>'), so the old guard was dead code — on a
    # big-endian host vectors round-tripped byte-swapped while
    # decode_vector always reads little-endian (self-review r3)
    v = np.asarray(vec).astype("<f2")
    return base64.b64encode(v.tobytes()).decode("ascii")


def decode_vector(text: str, dim: int) -> np.ndarray:
    raw = base64.b64decode(text.encode("ascii"))
    v = np.frombuffer(raw, dtype="<f2")
    if v.shape[0] != dim:
        raise ValueError(
            f"vetor corrompido: {v.shape[0]} floats, esperado {dim}"
        )
    return v


def upsert_embedding(
    db: Session, id_img: str, modelo: str, vec: np.ndarray
) -> EmbeddingImagem:
    row = db.get(EmbeddingImagem, str(id_img), modelo)
    if row is None:
        row = EmbeddingImagem(
            id_img=str(id_img), modelo=modelo, data_criado=tz.utcnow()
        )
        db.add(row)
    row.dim = int(np.asarray(vec).shape[-1])
    row.vetor = encode_vector(vec)
    row.data_criado = tz.utcnow()
    db.flush()
    return row


def get_embedding(
    db: Session, id_img: str, modelo: str
) -> Optional[np.ndarray]:
    row = db.get(EmbeddingImagem, str(id_img), modelo)
    if row is None:
        return None
    return decode_vector(row.vetor, row.dim)


def contar_embeddings(db: Session, modelo: str) -> int:
    r = db.fetchone(
        "SELECT COUNT(*) AS n FROM embeddings_imagem WHERE modelo = ?",
        (modelo,),
    )
    return int(r["n"]) if r else 0


def versao_corpus(db: Session, modelo: str) -> tuple[int, str]:
    """Cheap cache-invalidation key for the in-memory index: (count,
    latest write timestamp) changes on any insert/update."""
    r = db.fetchone(
        "SELECT COUNT(*) AS n, MAX(data_criado) AS t "
        "FROM embeddings_imagem WHERE modelo = ?",
        (modelo,),
    )
    return (int(r["n"]), str(r["t"] or "")) if r else (0, "")


def carregar_corpus(
    db: Session, modelo: str
) -> tuple[list[str], np.ndarray]:
    """All embeddings of a model as (hashes, matrix [N, D] float16) —
    the corpus the on-device search runs against."""
    rows = db.fetchall(
        "SELECT id_img, dim, vetor FROM embeddings_imagem "
        "WHERE modelo = ? ORDER BY id_img",
        (modelo,),
    )
    if not rows:
        return [], np.zeros((0, 0), np.float16)
    # dominant dim wins; rows with another dim (backbone changed while
    # old embeddings remain) are SKIPPED instead of crashing the whole
    # corpus load and taking every similarity endpoint down until manual
    # cleanup (self-review r3)
    dims = [int(r["dim"]) for r in rows]
    dim = max(set(dims), key=dims.count)
    hashes, vecs = [], []
    skipped = 0
    for r in rows:
        if int(r["dim"]) != dim:
            skipped += 1
            continue
        hashes.append(r["id_img"])
        vecs.append(decode_vector(r["vetor"], dim))
    if skipped:
        import logging

        logging.getLogger(__name__).warning(
            "corpus %s: %d embeddings com dim != %d ignorados "
            "(reindexe com POST /inferencia/indexar)", modelo, skipped, dim,
        )
    mat = np.stack(vecs)
    return hashes, mat


def hashes_sem_embedding(
    db: Session, modelo: str, limit: int = 500
) -> list[dict]:
    """Synced, still-present images lacking an embedding for ``modelo`` —
    the indexing route's work queue. Returns [{content_hash,
    caminho_img}]."""
    rows = db.fetchall(
        """
        SELECT content_hash, caminho_img FROM imagens
        WHERE existe_no_nextcloud = 1
          AND content_hash NOT IN (
              SELECT id_img FROM embeddings_imagem WHERE modelo = ?
          )
        ORDER BY data_proc, content_hash
        LIMIT ?
        """,
        (modelo, int(limit)),
    )
    return [dict(r) for r in rows]
