"""Auth routes: login (form), whitelist-gated signup, logout.

Contract parity with the reference (``app/api/routes/auth.py:74-248``):
same paths, payloads, status codes and error details.
"""

from __future__ import annotations

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.config import settings
from ics_tpu_torch.core.validators import (
    validar_cpf,
    validar_email,
    validar_forca_senha,
    validar_nome,
)
from ics_tpu_torch.crud import auditoria_crud, cadastro_permitido_crud, user_crud
from ics_tpu_torch.db.models import TipoUsuario
from ics_tpu_torch.services import auth_service
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/auth")


def _cookie_domain_or_none():
    v = settings.COOKIE_DOMAIN
    if v is None or str(v).strip().lower() in ("", "none"):
        return None
    return v


def set_auth_cookie(response: JSONResponse, access_token: str) -> None:
    samesite = (settings.COOKIE_SAMESITE or "lax").strip().lower()
    if samesite == "none" and not settings.COOKIE_SECURE:
        samesite = "lax"  # browsers require Secure with SameSite=None
    response.set_cookie(
        key=settings.COOKIE_NAME,
        value=access_token,
        max_age=settings.JWT_ACCESS_TOKEN_EXPIRE_MINUTES * 60,
        httponly=settings.COOKIE_HTTPONLY,
        samesite=None if not settings.COOKIE_SECURE else samesite,
        secure=settings.COOKIE_SECURE,
        path="/",
        domain=_cookie_domain_or_none(),
    )


def clear_auth_cookie(response: JSONResponse) -> None:
    response.delete_cookie(
        key=settings.COOKIE_NAME,
        samesite=settings.COOKIE_SAMESITE or "lax",
        secure=settings.COOKIE_SECURE,
        domain=_cookie_domain_or_none(),
        path="/",
    )


@router.post("/login")
async def login(request: Request):
    form = await request.form()
    username = form.get("username") or ""
    password = form.get("password") or ""
    db = request.state.db
    # opt-in brute-force limiter (LOGIN_RATE_LIMIT=0 default keeps exact
    # reference parity): ATTEMPTS per (email, client IP) sliding window,
    # reserved atomically BEFORE the slow scrypt verify (a parallel burst
    # gets at most `limit` password checks). Success clears the key.
    limit = int(settings.LOGIN_RATE_LIMIT or 0)
    rl_key = None
    login_failures = None
    if limit > 0:
        from ics_tpu_torch.core.ratelimit import login_failures

        client = request.scope.get("client") or ("?",)
        ip = client[0]
        if settings.LOGIN_RATE_TRUST_FORWARDED:
            # behind a reverse proxy scope['client'] is the PROXY for
            # everyone — without this opt-in an attacker could lock any
            # email out for all clients sharing the proxy IP. An appending
            # proxy chain puts the only trustworthy hop N-from-the-END
            # (earlier elements are client-supplied and forgeable), so key
            # on parts[-XFF_HOPS], never parts[0].
            fwd = (request.headers.get("x-forwarded-for") or "").strip()
            if fwd:
                parts = [p.strip() for p in fwd.split(",") if p.strip()]
                hops = max(1, int(settings.LOGIN_RATE_XFF_HOPS or 1))
                if hops <= len(parts):
                    ip = parts[-hops]
                # else: chain shorter than the configured trusted hops —
                # every element is then potentially client-supplied, so
                # fall back to the SOCKET ip (the proxy), never parts[0]
                # (an attacker-chosen key = unlimited attempts, or a
                # forged victim IP lockout)
        rl_key = f"{username.strip().lower()}|{ip}"
        wait = login_failures.attempt(
            rl_key, limit, settings.LOGIN_RATE_WINDOW_S
        )
        if wait > 0:
            raise HTTPException(
                429,
                "Muitas tentativas de login. Tente novamente em "
                f"{int(wait) + 1} segundos.",
                headers={"Retry-After": str(int(wait) + 1)},
            )
    user = await auth_service.authenticate_user(
        db, email=username, password=password
    )
    if user == auth_service.INACTIVE:
        raise HTTPException(
            403,
            "Esta conta foi desativada. Entre em contato com o administrador "
            "do sistema.",
        )
    if user is None:
        raise HTTPException(
            401, "Email ou senha incorretos",
            headers={"WWW-Authenticate": "Bearer"},
        )
    if rl_key is not None:
        login_failures.clear(rl_key)
    token = auth_service.create_access_token(db, user)
    user.data_ultimo_login = tz.local_to_utc(tz.now())
    auditoria_crud.registrar_evento(db, "login", user.id_usu, {"email": user.email})
    db.commit()
    response = JSONResponse(
        {"access_token": token, "token_type": "bearer", "user_type": user.id_tipo}
    )
    set_auth_cookie(response, token)
    return response


@router.post("/cadastro")
async def cadastrar_usuario(request: Request):
    dados = await request.json()
    db = request.state.db
    email = (dados.get("email") or "").strip().lower()
    nome_completo = dados.get("nome_completo") or ""
    cpf = dados.get("cpf") or ""
    senha = dados.get("senha") or ""
    telefone = dados.get("telefone")
    if not validar_email(email):
        raise HTTPException(422, "Email inválido.")

    if user_crud.get_user_by_email(db, email):
        raise HTTPException(400, "Email já cadastrado por outro usuário.")
    if user_crud.get_user_by_cpf(db, cpf):
        raise HTTPException(400, "CPF já cadastrado por outro usuário.")
    cadastro = cadastro_permitido_crud.get_cadastro_permitido_by_email(db, email)
    if not cadastro:
        raise HTTPException(403, "Email não está autorizado para cadastro.")
    if cadastro.usado:
        raise HTTPException(409, "Este email já foi utilizado para cadastro.")
    if cadastro.data_expiracao and cadastro.data_expiracao < tz.utcnow():
        raise HTTPException(410, "O cadastro permitido expirou.")
    if not validar_nome(nome_completo):
        raise HTTPException(422, "Nome completo inválido. Informe nome e sobrenome.")
    if not validar_cpf(cpf):
        raise HTTPException(422, "CPF inválido.")
    if not validar_forca_senha(senha):
        raise HTTPException(
            422,
            "Senha fraca. Use pelo menos 8 caracteres, incluindo maiúsculas, "
            "minúsculas e números.",
        )

    tipo = db.get(TipoUsuario, cadastro.id_tipo)
    if tipo is None:
        raise HTTPException(500, "Tipo de usuário não encontrado.")
    if tipo.nome.lower() == "convencional":
        usuario = user_crud.create_usuario_convencional(
            db, nome_completo, email, senha, cpf, tipo.id_tipo, telefone
        )
        evento_nome = "cadastrar_usuario_convencional"
    elif tipo.nome.lower() == "admin":
        usuario = user_crud.create_usuario_administrador(
            db, nome_completo, email, senha, cpf, tipo.id_tipo, telefone
        )
        evento_nome = "cadastrar_usuario_administrador"
    else:
        raise HTTPException(400, "Tipo de usuário inválido.")

    cadastro_permitido_crud.marcar_como_usado(db, email)
    auditoria_crud.registrar_evento(
        db, evento_nome, usuario.id_usu,
        {
            "email": usuario.email,
            "nome_completo": usuario.nome_completo,
            "tipo": tipo.nome,
            "telefone": usuario.telefone,
        },
    )
    db.commit()
    token = auth_service.create_access_token(db, usuario)
    response = JSONResponse(
        {"access_token": token, "token_type": "bearer", "user_type": usuario.id_tipo},
        201,
    )
    set_auth_cookie(response, token)
    return response


@router.post("/logout")
async def logout(request: Request):
    user = auth_service.get_current_user(request)
    db = request.state.db
    auditoria_crud.registrar_evento(db, "logout", user.id_usu, {"email": user.email})
    db.commit()
    response = JSONResponse({"message": "Logout realizado com sucesso"})
    clear_auth_cookie(response)
    return response
