"""Startup seeding: audit events, user types, initial admin.

Reference parity: ``app/db/database.py:73-97`` (audit events — here the
catalogue is complete, fixing defect SURVEY.md §2.4.3) and
``app/main.py:137-176`` (user types + initial admin from settings).
"""

from __future__ import annotations

import logging

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.core.security import hash_password
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.db.models import (
    AUDIT_EVENTS,
    EventoAuditoria,
    TipoUsuario,
    Usuario,
    UsuarioAdministrador,
)

logger = logging.getLogger(__name__)

TIPO_CONVENCIONAL = 1
TIPO_ADMINISTRADOR = 2


def popular_eventos_auditoria(session) -> int:
    created = 0
    existing = {
        r["nome"] for r in session.fetchall("SELECT nome FROM eventos_auditoria")
    }
    next_id = (
        session.fetchone("SELECT COALESCE(MAX(id_evento), 0) AS m FROM eventos_auditoria")["m"]
        + 1
    )
    # conflict-tolerant insert: two app replicas seeding the same PG
    # database both compute MAX+1 — the loser must continue, not crash
    # its startup with an IntegrityError (self-review r3)
    ignore = (
        "INSERT INTO eventos_auditoria (id_evento, nome, descricao) "
        "VALUES (?, ?, ?) ON CONFLICT DO NOTHING"
        if session.dialect == "postgres" else
        "INSERT OR IGNORE INTO eventos_auditoria "
        "(id_evento, nome, descricao) VALUES (?, ?, ?)"
    )
    for nome, descricao in AUDIT_EVENTS:
        if nome in existing:
            continue
        session.execute(ignore, [next_id, nome, descricao])
        next_id += 1
        created += 1
    return created


def popular_tipos_usuario(session) -> None:
    for id_tipo, nome in ((TIPO_CONVENCIONAL, "convencional"), (TIPO_ADMINISTRADOR, "admin")):
        if session.get(TipoUsuario, id_tipo) is None:
            session.add(TipoUsuario(id_tipo=id_tipo, nome=nome))
    session.flush()


def criar_admin_inicial(session) -> bool:
    existing = (
        session.query(Usuario).filter(Usuario.email == settings.ADMIN_EMAIL).first()
    )
    if existing is not None:
        return False
    now = tz.local_to_utc(tz.now())
    user = Usuario(
        nome_completo=settings.ADMIN_NOME_COMPLETO,
        email=settings.ADMIN_EMAIL,
        senha_hash=hash_password(settings.ADMIN_SENHA),
        data_criado=now,
        ativo=True,
        id_tipo=TIPO_ADMINISTRADOR,
    )
    session.add(user)
    session.flush()
    session.add(UsuarioAdministrador(cpf=settings.ADMIN_CPF, id_usu=user.id_usu))
    session.flush()
    logger.info("initial admin seeded: %s", settings.ADMIN_EMAIL)
    return True


def seed_all(db: Database) -> None:
    with db.session() as s:
        popular_eventos_auditoria(s)
        popular_tipos_usuario(s)
        criar_admin_inicial(s)
        s.commit()
