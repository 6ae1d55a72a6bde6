"""Whitelist (cadastros_permitidos) queries (reference:
``app/crud/cadastro_permitido_crud.py``)."""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import CadastroPermitido
from ics_tpu_torch.db.orm import and_


def get_cadastro_permitido_by_email(
    db: Session, email: str, only_active: bool = True
) -> Optional[CadastroPermitido]:
    q = db.query(CadastroPermitido).filter(CadastroPermitido.email == email)
    if only_active:
        q = q.filter(CadastroPermitido.ativo == True)  # noqa: E712
    return q.first()


def create_cadastro_permitido(
    db: Session, email: str, id_tipo: int, id_adm: str, data_expiracao=None
) -> CadastroPermitido:
    cad = CadastroPermitido(
        email=email,
        data_criado=tz.local_to_utc(tz.now()),
        usado=False,
        data_expiracao=data_expiracao,
        id_tipo=id_tipo,
        id_adm=id_adm,
        ativo=True,
    )
    db.add(cad)
    db.flush()
    return cad


def list_cadastros(db: Session) -> list[CadastroPermitido]:
    return db.query(CadastroPermitido).order_by(CadastroPermitido.data_criado.desc()).all()


def marcar_como_usado(db: Session, email: str) -> None:
    cad = get_cadastro_permitido_by_email(db, email)
    if cad is not None:
        cad.usado = True
        db.flush()


def get_by_id(db: Session, id_cad: str) -> Optional[CadastroPermitido]:
    return db.get(CadastroPermitido, str(id_cad))
