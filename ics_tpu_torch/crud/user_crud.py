"""User query/creation functions (reference: ``app/crud/user_crud.py``)."""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.security import hash_password
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import Usuario, UsuarioAdministrador, UsuarioConvencional


def get_user_by_email(db: Session, email: str) -> Optional[Usuario]:
    return db.query(Usuario).filter(Usuario.email == email).first()


def get_user_by_id(db: Session, id_usu: str) -> Optional[Usuario]:
    return db.get(Usuario, str(id_usu))


def get_user_by_cpf(db: Session, cpf: str) -> Optional[Usuario]:
    for subtype in (UsuarioConvencional, UsuarioAdministrador):
        row = db.query(subtype).filter(subtype.cpf == cpf).first()
        if row is not None:
            return get_user_by_id(db, row.id_usu)
    return None


def _create_base_user(
    db: Session, nome_completo: str, email: str, senha: str,
    id_tipo: int, telefone: Optional[str],
) -> Usuario:
    user = Usuario(
        nome_completo=nome_completo,
        email=email,
        telefone=telefone,
        senha_hash=hash_password(senha),
        data_criado=tz.local_to_utc(tz.now()),
        ativo=True,
        id_tipo=id_tipo,
    )
    db.add(user)
    db.flush()
    return user


def create_usuario_convencional(
    db: Session, nome_completo: str, email: str, senha: str, cpf: str,
    id_tipo: int, telefone: Optional[str] = None,
) -> Usuario:
    user = _create_base_user(db, nome_completo, email, senha, id_tipo, telefone)
    db.add(UsuarioConvencional(cpf=cpf, id_usu=user.id_usu))
    db.flush()
    return user


def create_usuario_administrador(
    db: Session, nome_completo: str, email: str, senha: str, cpf: str,
    id_tipo: int, telefone: Optional[str] = None,
) -> Usuario:
    user = _create_base_user(db, nome_completo, email, senha, id_tipo, telefone)
    db.add(UsuarioAdministrador(cpf=cpf, id_usu=user.id_usu))
    db.flush()
    return user


def get_convencional_by_usuario(db: Session, id_usu: str) -> Optional[UsuarioConvencional]:
    return (
        db.query(UsuarioConvencional)
        .filter(UsuarioConvencional.id_usu == str(id_usu))
        .first()
    )


def get_administrador_by_usuario(db: Session, id_usu: str) -> Optional[UsuarioAdministrador]:
    return (
        db.query(UsuarioAdministrador)
        .filter(UsuarioAdministrador.id_usu == str(id_usu))
        .first()
    )
