"""User management + "my account" routes
(reference: ``app/api/routes/usuarios.py``)."""

from __future__ import annotations

from ics_tpu_torch.core.security import hash_password, verify_password_async
from ics_tpu_torch.core.validators import validar_email, validar_forca_senha
from ics_tpu_torch.crud.user_crud import (
    get_administrador_by_usuario,
    get_convencional_by_usuario,
)
from ics_tpu_torch.db.models import TipoUsuario, Usuario
from ics_tpu_torch.services.auth_service import get_current_user, require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Response, Router

router = Router(prefix="/usuarios")


def _usuario_out(db, u: Usuario, include_id_con: bool = False) -> dict:
    tipo_row = db.get(TipoUsuario, u.id_tipo) if u.id_tipo else None
    tipo = tipo_row.nome if tipo_row else "desconhecido"
    con = get_convencional_by_usuario(db, u.id_usu)
    adm = get_administrador_by_usuario(db, u.id_usu) if con is None else None
    cpf = con.cpf if con else (adm.cpf if adm else None)
    out = {
        "id_usu": str(u.id_usu),
        "nome_completo": u.nome_completo,
        "email": u.email,
        "telefone": u.telefone,
        "tipo": tipo,
        "cpf": cpf,
        "is_admin": tipo.lower() == "admin",
        "ativo": u.ativo,
    }
    if include_id_con:
        out["id_con"] = str(con.id_con) if con else None
    return out


@router.get("/")
async def listar_usuarios(request: Request):
    db = request.state.db
    require_admin(request)
    usuarios = db.query(Usuario).all()
    return JSONResponse([_usuario_out(db, u, include_id_con=True) for u in usuarios])


@router.delete("/{id_usu}")
async def excluir_usuario(request: Request):
    db = request.state.db
    admin = require_admin(request)
    usuario = db.get(Usuario, request.path_params["id_usu"])
    if usuario is None:
        raise HTTPException(404, "Usuário não encontrado.")
    if not usuario.ativo:
        raise HTTPException(400, "Usuário já está desativado.")
    if usuario.id_usu == admin.id_usu:
        raise HTTPException(403, "Você não pode desativar a si mesmo.")
    usuario.ativo = False
    db.commit()
    return Response(b"", 204)


@router.patch("/{id_usu}/reativar")
async def reativar_usuario(request: Request):
    db = request.state.db
    require_admin(request)
    usuario = db.get(Usuario, request.path_params["id_usu"])
    if usuario is None:
        raise HTTPException(404, "Usuário não encontrado.")
    if usuario.ativo:
        raise HTTPException(400, "Usuário já está ativo.")
    usuario.ativo = True
    db.commit()
    return JSONResponse({"message": "Usuário reativado com sucesso."})


@router.get("/me")
async def ler_meus_dados(request: Request):
    db = request.state.db
    user = get_current_user(request)
    return JSONResponse(_usuario_out(db, user))


@router.patch("/me")
async def atualizar_meu_perfil(request: Request):
    db = request.state.db
    user = get_current_user(request)
    dados = await request.json()
    if dados.get("nome_completo"):
        user.nome_completo = dados["nome_completo"]
    if dados.get("telefone"):
        user.telefone = dados["telefone"]
    if dados.get("email"):
        if not validar_email(dados["email"]):
            raise HTTPException(422, "Email inválido.")
        existente = (
            db.query(Usuario).filter(Usuario.email == dados["email"]).first()
        )
        if existente is not None and existente.id_usu != user.id_usu:
            raise HTTPException(400, "Este e-mail já está em uso.")
        user.email = dados["email"]
    db.commit()
    return JSONResponse(_usuario_out(db, user))


@router.patch("/me/senha")
async def alterar_minha_senha(request: Request):
    db = request.state.db
    user = get_current_user(request)
    dados = await request.json()
    senha_atual = dados.get("senha_atual") or ""
    nova_senha = dados.get("nova_senha") or ""
    if not await verify_password_async(senha_atual, user.senha_hash):
        raise HTTPException(400, "A senha atual está incorreta.")
    if not validar_forca_senha(nova_senha):
        raise HTTPException(
            422,
            "Senha fraca. Use pelo menos 8 caracteres, incluindo maiúsculas, "
            "minúsculas e números.",
        )
    user.senha_hash = hash_password(nova_senha)
    db.commit()
    return JSONResponse({"message": "Senha alterada com sucesso."})
