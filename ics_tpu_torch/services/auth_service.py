"""Authentication service: credential check, JWT mint, request guards.

Reference: ``app/services/auth_service.py``. Behavioral fixes vs reference:
invalid/expired tokens raise 401 (the reference crashed with an undefined
``credentials_exception`` NameError -> 500, SURVEY.md §2.4.2).

Token claims keep the reference's shape: ``sub``, ``user_type``,
``user_type_id``, ``name``, ``email``, ``is_admin``, ``exp``.
"""

from __future__ import annotations

import asyncio
from datetime import timedelta
from typing import Optional, Union

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.core.security import (
    TokenError,
    hash_password,
    jwt_decode,
    jwt_encode,
    password_needs_rehash,
    verify_password_async,
)
from ics_tpu_torch.crud import user_crud
from ics_tpu_torch.db.engine import Session
from ics_tpu_torch.db.models import TipoUsuario, Usuario
from ics_tpu_torch.web.exceptions import HTTPException
from ics_tpu_torch.web.requests import Request

INACTIVE = "inativo"


async def authenticate_user(
    db: Session, email: str, password: str
) -> Union[Usuario, str, None]:
    """Returns the user, the sentinel ``"inativo"`` for disabled accounts
    (reference parity, ``auth_service.py:31-33``), or None.

    Async because the hash check runs off the event loop
    (``verify_password_async`` — the pure-Python bcrypt fallback for
    adopted credentials costs seconds of CPU and must not stall the
    single-threaded server)."""
    user = user_crud.get_user_by_email(db, email)
    if user is None:
        return None
    if not user.ativo:
        return INACTIVE
    if not await verify_password_async(password, user.senha_hash):
        return None
    if password_needs_rehash(user.senha_hash):
        # bcrypt credential carried over from an adopted reference DB
        # (``db/adopt.py``): upgrade to scrypt now that we hold the
        # plaintext; the login route's commit persists it, so the slow
        # bcrypt check runs exactly once per adopted user.
        user.senha_hash = await asyncio.to_thread(hash_password, password)
    return user


def _tipo_nome(db: Session, user: Usuario) -> str:
    tipo = db.get(TipoUsuario, user.id_tipo) if user.id_tipo else None
    return tipo.nome if tipo else ""


def create_access_token(db: Session, user: Usuario) -> str:
    tipo_nome = _tipo_nome(db, user)
    expire = tz.local_to_utc(tz.now()) + timedelta(
        minutes=settings.JWT_ACCESS_TOKEN_EXPIRE_MINUTES
    )
    claims = {
        "sub": str(user.id_usu),
        "user_type": tipo_nome,
        "user_type_id": user.id_tipo,
        "name": user.nome_completo,
        "email": user.email,
        "is_admin": tipo_nome.lower() == "admin",
        "exp": expire.timestamp(),
    }
    return jwt_encode(claims, settings.JWT_SECRET_KEY, settings.JWT_ALGORITHM)


def get_token_from_cookie_or_header(request: Request) -> Optional[str]:
    """Cookie first (frontend), then Bearer header (Swagger/API clients) —
    reference order (``auth_service.py:62-73``)."""
    token = request.cookies.get(settings.COOKIE_NAME)
    if token:
        return token
    auth = request.headers.get("authorization", "")
    if auth.startswith("Bearer "):
        return auth.split(" ", 1)[1]
    return None


_CREDENTIALS_EXC = lambda: HTTPException(  # noqa: E731
    401,
    "Não foi possível validar as credenciais",
    headers={"WWW-Authenticate": "Bearer"},
)


def get_current_user(request: Request) -> Usuario:
    db: Session = request.state.db
    token = get_token_from_cookie_or_header(request)
    if not token:
        raise HTTPException(
            401, "Not authenticated", headers={"WWW-Authenticate": "Bearer"}
        )
    try:
        payload = jwt_decode(token, settings.JWT_SECRET_KEY, settings.JWT_ALGORITHM)
    except TokenError:
        raise _CREDENTIALS_EXC()
    user_id = payload.get("sub")
    if not user_id:
        raise _CREDENTIALS_EXC()
    user = user_crud.get_user_by_id(db, user_id)
    if user is None:
        raise _CREDENTIALS_EXC()
    return user


def require_admin(request: Request) -> Usuario:
    user = get_current_user(request)
    db: Session = request.state.db
    if not user.id_tipo:
        raise HTTPException(403, "Usuário sem tipo definido.")
    if _tipo_nome(db, user).lower() != "admin":
        raise HTTPException(
            403, "Apenas administradores podem realizar esta ação."
        )
    return user
