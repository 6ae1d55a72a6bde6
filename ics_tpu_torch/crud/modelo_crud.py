"""Trained-model registry + model-suggestion CRUD (net-new TPU tier).

No reference counterpart: the reference has no model inference at all
(SURVEY.md §0); this registry is how fine-tuned weights become the serving
version for an ambiente's ``classificar-tpu`` path.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import ModeloTreinado, Opcao, SugestaoModelo


def registrar_modelo(
    db: Session,
    id_amb: str,
    nome_modelo: str,
    num_classes: int,
    class_map: dict,
    dir_checkpoint: str,
    passo: int = 0,
    metricas: Optional[dict] = None,
    ativar: bool = True,
) -> ModeloTreinado:
    """Register a fine-tune result; ``versao`` auto-increments per ambiente.

    ``ativar=True`` promotes it to the serving version (one active model
    per ambiente — the previous one is demoted in the same transaction).
    """
    existing = (
        db.query(ModeloTreinado)
        .filter(ModeloTreinado.id_amb == str(id_amb))
        .all()
    )
    versao = max((m.versao for m in existing), default=0) + 1
    if ativar:
        for m in existing:
            if m.ativo:
                m.ativo = False
    row = ModeloTreinado(
        id_amb=str(id_amb),
        nome_modelo=nome_modelo,
        versao=versao,
        num_classes=num_classes,
        class_map={str(k): int(v) for k, v in class_map.items()},
        dir_checkpoint=str(dir_checkpoint),
        passo=int(passo),
        metricas=metricas,
        ativo=ativar,
        data_criado=tz.utcnow(),
    )
    db.add(row)
    db.flush()
    return row


def modelo_ativo(db: Session, id_amb: str) -> Optional[ModeloTreinado]:
    return (
        db.query(ModeloTreinado)
        .filter(ModeloTreinado.id_amb == str(id_amb), ModeloTreinado.ativo == True)  # noqa: E712
        .first()
    )


def get_modelo(db: Session, id_mod: str) -> Optional[ModeloTreinado]:
    return db.get(ModeloTreinado, str(id_mod))


def listar_modelos(db: Session, id_amb: Optional[str] = None):
    q = db.query(ModeloTreinado)
    if id_amb is not None:
        q = q.filter(ModeloTreinado.id_amb == str(id_amb))
    rows = q.all()
    return sorted(rows, key=lambda m: (str(m.id_amb), m.versao))


def ativar_modelo(db: Session, id_mod: str) -> Optional[ModeloTreinado]:
    """Promote a registry version to serving (demotes its ambiente's
    current active version)."""
    row = db.get(ModeloTreinado, str(id_mod))
    if row is None:
        return None
    for m in (
        db.query(ModeloTreinado)
        .filter(ModeloTreinado.id_amb == str(row.id_amb))
        .all()
    ):
        m.ativo = m.id_mod == row.id_mod
    db.flush()
    return row


def inverse_class_map(row: ModeloTreinado) -> dict[int, str]:
    """class index -> id_opc."""
    return {int(v): str(k) for k, v in (row.class_map or {}).items()}


def calcular_incerteza(
    classes: Optional[list[dict]],
    multi_rotulo: bool = False,
    limiar: float = 0.5,
) -> Optional[float]:
    """Model uncertainty in [0, 1] from a suggestion's score list — the
    active-learning ranking key (higher = the specialist's label teaches
    the model more).

    Single-label (softmax): margin sampling, ``1 - (p1 - p2)`` over the
    two highest scores (``1 - p1`` when only one class is known) — the
    standard AL acquisition that is robust to top-k truncation, unlike
    entropy over a truncated distribution.

    Multi-label (independent sigmoids): proximity of the MOST ambiguous
    class to the calibrated decision threshold, ``max_c (1 - 2|p_c -
    limiar| / span)`` where span normalizes the asymmetric [0, limiar] /
    [limiar, 1] sides — 1.0 exactly at the boundary, 0.0 at certainty.
    """
    scores = sorted(
        (
            float(c["score"])
            for c in (classes or [])
            if isinstance(c, dict) and c.get("score") is not None
        ),
        reverse=True,
    )
    if not scores:
        return None
    if multi_rotulo:
        worst = 0.0
        for p in scores:
            span = limiar if p < limiar else (1.0 - limiar)
            if span <= 0.0:
                continue
            worst = max(worst, 1.0 - abs(p - limiar) / span)
        return min(max(worst, 0.0), 1.0)
    margin = scores[0] - (scores[1] if len(scores) > 1 else 0.0)
    return min(max(1.0 - margin, 0.0), 1.0)


def registrar_sugestao(
    db: Session,
    id_img: str,
    modelo: str,
    classes: list[dict],
    score: Optional[float] = None,
    id_amb: Optional[str] = None,
    id_mod: Optional[str] = None,
    id_opc: Optional[str] = None,
    versao: Optional[int] = None,
) -> SugestaoModelo:
    """Upsert the (image, ambiente-or-generic, model) suggestion: a rerun
    with newer weights replaces the stale suggestion instead of stacking.

    ``incerteza`` is computed at write time (from the model's calibrated
    threshold when multi-label) so the priorizadas page can ORDER BY it
    in SQL on both dialects."""
    q = db.query(SugestaoModelo).filter(
        SugestaoModelo.id_img == str(id_img),
        SugestaoModelo.modelo == modelo,
    )
    if id_amb is None:
        q = q.filter(SugestaoModelo.id_amb == None)  # noqa: E711
    else:
        q = q.filter(SugestaoModelo.id_amb == str(id_amb))
    row = q.first()
    if row is None:
        row = SugestaoModelo(
            id_img=str(id_img),
            id_amb=str(id_amb) if id_amb else None,
            modelo=modelo,
            data_criado=tz.utcnow(),
        )
        db.add(row)
    row.id_mod = str(id_mod) if id_mod else None
    row.id_opc = str(id_opc) if id_opc else None
    row.versao = versao
    row.score = float(score) if score is not None else None
    row.classes = classes
    multi, limiar = False, 0.5
    if id_mod is not None:
        mod = db.get(ModeloTreinado, str(id_mod))
        meta = (mod.metricas or {}) if mod else {}
        multi = bool(meta.get("multi_rotulo"))
        limiar = float(meta.get("limiar") or 0.5)
    row.incerteza = calcular_incerteza(classes, multi_rotulo=multi,
                                       limiar=limiar)
    row.data_criado = tz.utcnow()
    db.flush()
    return row


def imagens_sem_sugestao(
    db: Session, id_amb: str, versao: int, limit: int = 500
) -> list[dict]:
    """Synced, still-present images of the ambiente's conjuntos lacking a
    suggestion from the given model VERSION — the bulk-refresh work queue
    (a promotion leaves the corpus annotated by the previous version until
    each image is re-seen). Returns [{content_hash, caminho_img}]."""
    from ics_tpu_torch.crud.classificacao_crud import buscar_conjuntos_ambiente

    conjuntos_ids = buscar_conjuntos_ambiente(db, id_amb)
    if not conjuntos_ids:
        return []
    marks = ", ".join("?" for _ in conjuntos_ids)
    rows = db.fetchall(
        f"""
        SELECT content_hash, caminho_img FROM imagens
        WHERE id_cnj IN ({marks})
          AND existe_no_nextcloud = 1
          AND content_hash NOT IN (
              SELECT id_img FROM sugestoes_modelo
              WHERE id_amb = ? AND versao = ?
          )
        ORDER BY data_proc, content_hash
        LIMIT ?
        """,
        list(conjuntos_ids) + [str(id_amb), int(versao), int(limit)],
    )
    return [dict(r) for r in rows]


def imagens_priorizadas(
    db: Session, id_amb: str, id_con: str, limit: int = 20
) -> list[tuple]:
    """Active-learning page: the user's UNCLASSIFIED images of the
    ambiente ranked by model uncertainty (most uncertain first) — the
    images whose human label most improves the next fine-tune.

    Only ambiente-specific suggestions rank (the trained model's
    uncertainty about ITS classes; a generic-model's 1000-way entropy says
    nothing about the ambiente's options). Returns ``[(Imagem, incerteza),
    ...]``; hash breaks ties so the order is total and stable."""
    from ics_tpu_torch.crud.classificacao_crud import buscar_conjuntos_ambiente

    conjuntos_ids = buscar_conjuntos_ambiente(db, id_amb)
    if not conjuntos_ids:
        return []
    marks = ", ".join("?" for _ in conjuntos_ids)
    # ONE row per image (an image can hold several suggestion rows per
    # ambiente: knn:<backbone> AND the trained model — the plain JOIN
    # duplicated page entries); the unclassified filter is scoped to
    # THIS ambiente's options like buscar_imagens_inicial
    # (self-review r3)
    sql = f"""
        SELECT imagens.*, s.incerteza AS _incerteza
        FROM imagens
        JOIN (
            SELECT id_img, MAX(incerteza) AS incerteza
            FROM sugestoes_modelo
            WHERE id_amb = ? AND incerteza IS NOT NULL
            GROUP BY id_img
        ) s ON s.id_img = imagens.content_hash
        WHERE imagens.id_cnj IN ({marks})
          AND imagens.existe_no_nextcloud = 1
          AND imagens.content_hash NOT IN (
              SELECT DISTINCT c.id_img FROM classificacoes c
              JOIN opcoes o ON o.id_opc = c.id_opc
              WHERE c.id_con = ? AND c.ativo = 1 AND o.id_amb = ?
          )
        ORDER BY s.incerteza DESC, imagens.content_hash
        LIMIT ?
    """
    params = [str(id_amb)] + list(conjuntos_ids) + [
        str(id_con), str(id_amb), int(limit)
    ]
    from ics_tpu_torch.db.models import Imagem

    return [
        (Imagem.from_row(r), float(r["_incerteza"]))
        for r in db.fetchall(sql, params)
    ]


def sugestoes_por_imagens(
    db: Session, hashes: Sequence[str], id_amb: Optional[str] = None
) -> dict[str, dict]:
    """hash -> rendered suggestion for the paging payload.

    Ambiente-specific suggestions win; generic-model suggestions are the
    fallback so freshly-synced images surface something before any
    fine-tune has run."""
    out: dict[str, dict] = {}
    if not hashes:
        return out
    rows = (
        db.query(SugestaoModelo)
        .filter(SugestaoModelo.id_img.in_([str(h) for h in hashes]))
        .all()
    )
    opcao_texto: dict[str, str] = {}
    modelo_meta: dict[str, dict] = {}

    def _meta(id_mod) -> dict:
        # multi-label models threshold the suggested set with their
        # calibrated limiar (train/job.py metricas) — cached per model
        if id_mod is None:
            return {}
        key = str(id_mod)
        if key not in modelo_meta:
            mod = db.get(ModeloTreinado, key)
            modelo_meta[key] = (mod.metricas or {}) if mod else {}
        return modelo_meta[key]

    def render(row: SugestaoModelo) -> dict:
        texto = None
        if row.id_opc:
            if row.id_opc not in opcao_texto:
                opc = db.get(Opcao, row.id_opc)
                opcao_texto[row.id_opc] = opc.texto if opc else None
            texto = opcao_texto[row.id_opc]
        out = {
            "modelo": row.modelo,
            "versao": row.versao,
            "id_opc": str(row.id_opc) if row.id_opc else None,
            "texto_opcao": texto,
            "score": row.score,
            "classes": row.classes,
            "incerteza": row.incerteza,
        }
        meta = _meta(row.id_mod)
        if meta.get("multi_rotulo"):
            limiar = float(meta.get("limiar") or 0.5)
            out["multi_rotulo"] = True
            out["limiar"] = limiar
            out["sugeridas"] = [
                c for c in (row.classes or [])
                if isinstance(c, dict)
                and float(c.get("score") or 0.0) >= limiar
            ]
        return out

    def rank(row) -> tuple:
        # deterministic pick when one image has several ambiente rows
        # (knn + trained model): trained (versao set) beats knn, newer
        # beats older — last-row-wins over an unordered query showed the
        # stale knn suggestion nondeterministically (self-review r3)
        return (row.versao is not None, str(row.data_criado or ""))

    best: dict[str, SugestaoModelo] = {}
    generic: dict[str, SugestaoModelo] = {}
    for row in rows:
        if id_amb is not None and str(row.id_amb or "") == str(id_amb):
            cur = best.get(row.id_img)
            if cur is None or rank(row) > rank(cur):
                best[row.id_img] = row
        elif row.id_amb is None:
            cur = generic.get(row.id_img)
            if cur is None or rank(row) > rank(cur):
                generic[row.id_img] = row
    for h, row in best.items():
        out[h] = render(row)
    for h, row in generic.items():
        if h not in out:
            out[h] = render(row)
    return out
