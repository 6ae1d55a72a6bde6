"""Audit log queries + the write-side helper used by every audited route
(reference: ``app/crud/auditoria_crud.py`` + inline LogAuditoria writes)."""

from __future__ import annotations

from typing import Any, Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import EventoAuditoria, LogAuditoria


def registrar_evento(
    db: Session,
    nome_evento: str,
    id_usu: Optional[str],
    detalhes: Optional[dict[str, Any]] = None,
) -> Optional[LogAuditoria]:
    """Write an audit row. Unlike the reference (which silently skipped when
    the event name wasn't seeded, §2.4.3), the complete catalogue means this
    always finds the event; an unknown name is a programming error surfaced
    in logs, not silent data loss."""
    evento = (
        db.query(EventoAuditoria).filter(EventoAuditoria.nome == nome_evento).first()
    )
    if evento is None:
        import logging

        logging.getLogger(__name__).error("unknown audit event: %s", nome_evento)
        return None
    log = LogAuditoria(
        id_usu=str(id_usu) if id_usu else None,
        evento_id=evento.id_evento,
        data_evento=tz.utcnow(),
        detalhes=detalhes,
    )
    db.add(log)
    db.flush()
    return log


def listar_logs(
    db: Session,
    id_usu: Optional[str] = None,
    evento_id: Optional[int] = None,
    page: int = 1,
    page_size: int = 50,
    data_inicio: Optional[str] = None,
    data_fim: Optional[str] = None,
) -> tuple[list[dict], int]:
    where = ["1=1"]
    params: list[Any] = []
    if id_usu:
        where.append("l.id_usu = ?")
        params.append(str(id_usu))
    if evento_id is not None:
        where.append("l.evento_id = ?")
        params.append(evento_id)
    if data_inicio:
        where.append("l.data_evento >= ?")
        params.append(data_inicio)
    if data_fim:
        where.append("l.data_evento <= ?")
        params.append(data_fim)
    cond = " AND ".join(where)
    total = db.fetchone(
        f"SELECT COUNT(*) AS n FROM logs_auditoria l WHERE {cond}", params
    )["n"]
    rows = db.fetchall(
        f"""
        SELECT l.id_log, l.id_usu, l.evento_id, l.data_evento, l.detalhes,
               e.nome AS evento_nome, u.email AS usuario_email,
               u.nome_completo AS usuario_nome
        FROM logs_auditoria l
        JOIN eventos_auditoria e ON e.id_evento = l.evento_id
        LEFT JOIN usuarios u ON u.id_usu = l.id_usu
        WHERE {cond}
        ORDER BY l.data_evento DESC
        LIMIT ? OFFSET ?
        """,
        params + [page_size, (page - 1) * page_size],
    )
    import json

    for r in rows:
        if isinstance(r.get("detalhes"), str):
            r["detalhes"] = json.loads(r["detalhes"])
    return rows, total


def listar_eventos(db: Session) -> list[EventoAuditoria]:
    return db.query(EventoAuditoria).order_by(EventoAuditoria.id_evento.asc()).all()
