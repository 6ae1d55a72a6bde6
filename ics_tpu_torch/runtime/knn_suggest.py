"""kNN label suggestions from the embedding index (net-new tier of the JAX package).

Cold-start for the suggestion loop: an ambiente with specialist labels
and an embedding index — but no fine-tuned model yet — can already
suggest labels by similarity-weighted voting over an image's nearest
LABELED neighbours. The vote runs on the same on-device cosine top-k the
similarity endpoints use; only the label join happens host-side.

Votes become regular ``sugestoes_modelo`` rows (``modelo="knn:<backbone>"``),
so they surface in the paging payload and feed the active-learning
``priorizadas`` ranking exactly like fine-tune suggestions do.
"""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.crud.embedding_crud import get_embedding
from ics_tpu_torch.db.models import Classificacao, Imagem, Opcao


def rotulos_por_imagens(db, hashes, id_amb: str) -> dict[str, set[str]]:
    """hash -> set of id_opc actively assigned by ANY specialist, limited
    to the ambiente's own options (labels from other ambientes sharing the
    image must not leak into the vote)."""
    if not hashes:
        return {}
    ambiente_opcoes = {
        str(o.id_opc)
        for o in db.query(Opcao).filter(Opcao.id_amb == str(id_amb)).all()
    }
    rows = (
        db.query(Classificacao)
        .filter(
            Classificacao.id_img.in_(list(hashes)),
            Classificacao.ativo == True,  # noqa: E712
        )
        .all()
    )
    out: dict[str, set[str]] = {}
    for c in rows:
        if str(c.id_opc) in ambiente_opcoes:
            out.setdefault(c.id_img, set()).add(str(c.id_opc))
    return out


def knn_sugerir(
    db,
    index,
    id_amb: str,
    content_hash: str,
    k: int = 10,
    multi_label: bool = False,
) -> Optional[dict]:
    """Similarity-weighted vote over the ``k`` nearest LABELED neighbours.

    Single-label: option scores are cosine-weight shares (sum to 1) — the
    top-2 margin then doubles as the priorizadas uncertainty. Multi-label:
    each option's score is the weight fraction of neighbours carrying it
    (independent per option; >=0.5 = suggested). Returns None when the
    image has no embedding; a result with ``vizinhos == 0`` when nothing
    labeled is nearby."""
    vec = get_embedding(db, content_hash, index.modelo)
    if vec is None:
        return None
    matches = index.search(vec, k=index.K_MAX, exclude=content_hash)
    labels = rotulos_por_imagens(
        db, [m["content_hash"] for m in matches], id_amb
    )
    weights: dict[str, float] = {}
    total = 0.0
    used = 0
    for m in matches:
        opcoes = labels.get(m["content_hash"])
        if not opcoes:
            continue
        w = max(float(m["score"]), 0.0)
        if w <= 0.0:
            continue
        used += 1
        total += w
        if multi_label:
            # independent per-class votes: full weight to every label
            for id_opc in opcoes:
                weights[id_opc] = weights.get(id_opc, 0.0) + w
        else:
            # single-label: a neighbour carrying SEVERAL active labels
            # (specialists disagreeing) splits its weight — otherwise two
            # options each scored 1.0 and the sum-to-1 contract (and the
            # top-2-margin uncertainty built on it) broke (self-review r3)
            share = w / len(opcoes)
            for id_opc in opcoes:
                weights[id_opc] = weights.get(id_opc, 0.0) + share
        if used >= k:
            break
    if not weights or total <= 0.0:
        return {"vizinhos": 0, "opcoes": []}
    opcoes = [
        {"id_opc": id_opc, "score": w / total}
        for id_opc, w in weights.items()
    ]
    opcoes.sort(key=lambda o: (-o["score"], o["id_opc"]))
    return {"vizinhos": used, "opcoes": opcoes, "multi_rotulo": multi_label}


def existe_imagem_no_ambiente(db, id_amb: str, content_hash: str) -> bool:
    from ics_tpu_torch.crud.classificacao_crud import buscar_conjuntos_ambiente

    img = db.get(Imagem, str(content_hash))
    if img is None or not img.existe_no_nextcloud:
        return False
    return img.id_cnj in set(buscar_conjuntos_ambiente(db, id_amb))
