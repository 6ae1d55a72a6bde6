"""Classification CRUD: progress cursor, keyset pagination, delta
reclassification (reference: ``app/crud/classificacao_crud.py``).

Keyset pagination is ordered by ``(id_cnj, data_proc, content_hash)`` with a
``limit+1`` has-more probe, identical to the reference's cursor semantics.
Timestamps are stored as fixed-offset UTC ISO-8601 text, which sorts
lexicographically in timestamp order.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import (
    AmbienteConjuntoImagens,
    Classificacao,
    Imagem,
    Opcao,
    UsuarioAmbienteProgresso,
)
from ics_tpu_torch.db.orm import and_, or_

logger = logging.getLogger(__name__)

PAGE = 20


def obter_progresso_usuario(
    db: Session, id_con: str, id_amb: str
) -> UsuarioAmbienteProgresso:
    progresso = db.get(UsuarioAmbienteProgresso, str(id_con), str(id_amb))
    if progresso is None:
        progresso = UsuarioAmbienteProgresso(
            id_con=str(id_con),
            id_amb=str(id_amb),
            total_classificadas=0,
            data_ultima_atividade=tz.utcnow(),
        )
        db.add(progresso)
        db.flush()
    return progresso


def buscar_conjuntos_ambiente(db: Session, id_amb: str) -> list[str]:
    rows = (
        db.query(AmbienteConjuntoImagens)
        .filter(
            AmbienteConjuntoImagens.id_amb == str(id_amb),
            AmbienteConjuntoImagens.ativo == True,  # noqa: E712
        )
        .all()
    )
    return [r.id_cnj for r in rows]


def _imagens_base_query(db: Session, conjuntos_ids: Sequence[str]):
    return db.query(Imagem).filter(
        Imagem.id_cnj.in_(conjuntos_ids),
        Imagem.existe_no_nextcloud == True,  # noqa: E712
    )


# ORDER BY matches the keyset predicate exactly — (data_proc, content_hash)
# is a total order (hash is unique). The reference ordered by id_cnj first
# while filtering only on (data_proc, hash), which strands/skips images when
# an ambiente spans conjuntos with interleaved timestamps (defect fixed).
_ORDER_ASC = ("imagens.data_proc ASC", "imagens.content_hash ASC")
_ORDER_DESC = ("imagens.data_proc DESC", "imagens.content_hash DESC")


def buscar_imagens_inicial(
    db: Session, id_amb: str, id_con: str, limit: int = PAGE
) -> tuple[list[Imagem], bool]:
    from ics_tpu_torch.db.orm import DateTime as _DT

    progresso = obter_progresso_usuario(db, id_con, id_amb)
    conjuntos_ids = buscar_conjuntos_ambiente(db, id_amb)
    if not conjuntos_ids:
        return [], False

    marks = ", ".join("?" for _ in conjuntos_ids)
    sql = f"""
        SELECT * FROM imagens
        WHERE id_cnj IN ({marks})
          AND existe_no_nextcloud = 1
          AND content_hash NOT IN (
              SELECT DISTINCT c.id_img FROM classificacoes c
              JOIN opcoes o ON o.id_opc = c.id_opc
              WHERE c.id_con = ? AND c.ativo = 1 AND o.id_amb = ?
          )
    """
    # subquery scoped to THIS ambiente's options: classifying an image
    # in ambiente A must not hide it from B's work queue when a conjunto
    # is shared (self-review r3)
    params: list = list(conjuntos_ids) + [str(id_con), str(id_amb)]
    if (
        progresso.ultimo_data_proc_processado
        and progresso.ultimo_content_hash_processado
    ):
        cursor_dt = _DT().encode(progresso.ultimo_data_proc_processado)
        sql += " AND (data_proc > ? OR (data_proc = ? AND content_hash > ?))"
        params += [cursor_dt, cursor_dt, progresso.ultimo_content_hash_processado]
    sql += " ORDER BY data_proc, content_hash LIMIT ?"
    params.append(limit + 1)
    rows = [Imagem.from_row(r) for r in db.fetchall(sql, params)]
    tem_mais = len(rows) > limit
    return rows[:limit], tem_mais


def _ref_image_in_ambiente(
    db: Session, id_amb: str, content_hash: str
) -> tuple[Optional[Imagem], list[str]]:
    imagem = db.get(Imagem, content_hash)
    conjuntos_ids = buscar_conjuntos_ambiente(db, id_amb)
    if imagem is None or imagem.id_cnj not in conjuntos_ids:
        return None, conjuntos_ids
    return imagem, conjuntos_ids


def buscar_imagens_avancar(
    db: Session, id_amb: str, id_con: str, content_hash: str, limit: int = PAGE
) -> tuple[list[Imagem], bool]:
    ref, conjuntos_ids = _ref_image_in_ambiente(db, id_amb, content_hash)
    if ref is None:
        return [], False
    q = _imagens_base_query(db, conjuntos_ids).filter(
        or_(
            Imagem.data_proc > ref.data_proc,
            and_(
                Imagem.data_proc == ref.data_proc,
                Imagem.content_hash > ref.content_hash,
            ),
        )
    )
    rows = q.order_by(*_ORDER_ASC).limit(limit + 1).all()
    tem_mais = len(rows) > limit
    return rows[:limit], tem_mais


def buscar_imagens_voltar(
    db: Session, id_amb: str, id_con: str, content_hash: str, limit: int = PAGE
) -> tuple[list[Imagem], bool]:
    ref, conjuntos_ids = _ref_image_in_ambiente(db, id_amb, content_hash)
    if ref is None:
        return [], False
    q = _imagens_base_query(db, conjuntos_ids).filter(
        or_(
            Imagem.data_proc < ref.data_proc,
            and_(
                Imagem.data_proc == ref.data_proc,
                Imagem.content_hash < ref.content_hash,
            ),
        )
    )
    rows = q.order_by(*_ORDER_DESC).limit(limit + 1).all()
    tem_mais = len(rows) > limit
    # keep the `limit` rows NEAREST the reference (the DESC head), then
    # restore ascending order — slicing after the reverse dropped the
    # adjacent previous image and kept the probe row (reference defect)
    rows = rows[:limit]
    rows.reverse()
    return rows, tem_mais


def obter_classificacoes_imagens(
    db: Session, id_con: str, imagens: Sequence[Imagem]
) -> dict[str, list[Classificacao]]:
    if not imagens:
        return {}
    hashes = [img.content_hash for img in imagens]
    rows = (
        db.query(Classificacao)
        .filter(
            Classificacao.id_con == str(id_con),
            Classificacao.id_img.in_(hashes),
            Classificacao.ativo == True,  # noqa: E712
        )
        .all()
    )
    out: dict[str, list[Classificacao]] = {}
    for c in rows:
        out.setdefault(c.id_img, []).append(c)
    return out


def contar_imagens_classificadas(db: Session, id_con: str) -> int:
    return db.fetchone(
        "SELECT COUNT(DISTINCT id_img) AS n FROM classificacoes "
        "WHERE id_con = ? AND ativo = 1",
        [str(id_con)],
    )["n"]


def criar_ou_atualizar_classificacao(
    db: Session, id_con: str, id_amb: str, content_hash: str,
    id_opc: Sequence[str],
) -> tuple[list[Classificacao], int]:
    """Delta reclassification: deactivate removed options, reactivate
    previously-inactive ones, create the genuinely new — never deleting
    history (soft-delete semantics)."""
    if not id_opc:
        return [], 0
    imagem = db.get(Imagem, content_hash)
    if imagem is None:
        return [], 0
    conjuntos_ids = buscar_conjuntos_ambiente(db, id_amb)
    if imagem.id_cnj not in conjuntos_ids:
        # route-level check rejects before this; keep defense-in-depth here
        # (the reference logged but proceeded — §2.4.5; we enforce)
        return [], 0

    opcoes_validas: dict[str, Opcao] = {}
    for oid in id_opc:
        opcao = db.get(Opcao, str(oid))
        if opcao is None:
            continue
        if str(opcao.id_amb) != str(id_amb):
            # option from another ambiente is invalid here (§2.4.5 enforced)
            continue
        opcoes_validas[str(oid)] = opcao
    if not opcoes_validas:
        return [], 0

    existentes = (
        db.query(Classificacao)
        .filter(
            Classificacao.id_con == str(id_con),
            Classificacao.id_img == content_hash,
        )
        .all()
    )
    # scope the delta to THIS ambiente's options: a conjunto shared by
    # two ambientes must not let classifying in B soft-delete the same
    # user's classification made in A (self-review r3)
    ambiente_opcoes = {
        str(o.id_opc)
        for o in db.query(Opcao).filter(Opcao.id_amb == str(id_amb)).all()
    }
    existentes = [c for c in existentes if str(c.id_opc) in ambiente_opcoes]
    ativas = {c.id_opc: c for c in existentes if c.ativo}
    inativas = {c.id_opc: c for c in existentes if not c.ativo}

    manter = set(opcoes_validas)
    inativar = set(ativas) - manter
    criar = manter - set(ativas) - set(inativas)
    reativar = manter & set(inativas)

    agora = tz.utcnow()
    resultado: list[Classificacao] = []
    total_novas = 0

    for oid in inativar:
        c = ativas[oid]
        c.ativo = False
        c.data_modificado = agora
    for oid in reativar:
        c = inativas[oid]
        c.ativo = True
        c.data_modificado = agora
        resultado.append(c)
    for oid in manter & set(ativas):
        resultado.append(ativas[oid])
    for oid in criar:
        nova = Classificacao(
            id_con=str(id_con),
            id_img=content_hash,
            id_opc=oid,
            data_criado=agora,
            ativo=True,
        )
        db.add(nova)
        resultado.append(nova)
        total_novas += 1

    progresso = obter_progresso_usuario(db, id_con, id_amb)
    progresso.ultimo_data_proc_processado = imagem.data_proc
    progresso.ultimo_content_hash_processado = imagem.content_hash
    progresso.data_ultima_atividade = agora
    tinha = len(ativas) > 0
    if (total_novas > 0 or reativar) and not tinha:
        progresso.total_classificadas += 1

    db.flush()
    return resultado, total_novas


def listar_historico(
    db: Session, id_con: str, id_amb: Optional[str], page: int, page_size: int
) -> tuple[int, list[dict]]:
    """Joined, grouped history (reference ``classificacoes.py:498-584``)."""
    where = ["c.id_con = ?", "c.ativo = 1"]
    params: list = [str(id_con)]
    if id_amb:
        where.append("a.id_amb = ?")
        params.append(str(id_amb))
    cond = " AND ".join(where)
    # the classification's ambiente IS its option's ambiente: joining
    # through ambientes_conjuntos_imagens multiplied rows (and
    # misattributed them) whenever one conjunto belongs to two ambientes
    # (self-review r3)
    base = f"""
        FROM classificacoes c
        JOIN imagens i ON i.content_hash = c.id_img
        JOIN opcoes o ON o.id_opc = c.id_opc
        JOIN conjuntos_imagens cj ON cj.id_cnj = i.id_cnj
        JOIN ambientes a ON a.id_amb = o.id_amb
        WHERE {cond}
    """
    total = db.fetchone(f"SELECT COUNT(*) AS n {base}", params)["n"]
    rows = db.fetchall(
        f"""
        SELECT c.id_cla, c.data_criado, i.content_hash, i.nome_img,
               i.caminho_img, o.texto AS opcao_texto, o.id_opc,
               a.titulo_amb, a.id_amb
        {base}
        ORDER BY c.data_criado DESC
        LIMIT ? OFFSET ?
        """,
        params + [page_size, (page - 1) * page_size],
    )
    return total, rows
