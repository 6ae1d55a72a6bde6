"""Option CRUD (reference: ``app/crud/opcao_crud.py``)."""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import Ambiente, Opcao


def criar_opcao(db: Session, id_amb: str, texto: str) -> Optional[Opcao]:
    texto = (texto or "").strip()
    if not texto or len(texto) > 255:
        return None
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None or not ambiente.ativo:
        return None
    dup = (
        db.query(Opcao)
        .filter(Opcao.id_amb == str(id_amb), Opcao.texto == texto)
        .first()
    )
    if dup is not None:
        return None
    opcao = Opcao(texto=texto, id_amb=str(id_amb))
    db.add(opcao)
    db.flush()
    return opcao


def listar_opcoes_ambiente(db: Session, id_amb: str):
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None:
        return None, []
    opcoes = (
        db.query(Opcao)
        .filter(Opcao.id_amb == str(id_amb))
        .order_by(Opcao.texto.asc())
        .all()
    )
    return ambiente, opcoes


def get_opcao(db: Session, id_opc: str) -> Optional[Opcao]:
    return db.get(Opcao, str(id_opc))
