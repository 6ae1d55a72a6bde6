"""Whitelist admin CRUD (reference: ``app/api/routes/whitelist.py``)."""

from __future__ import annotations

from ics_tpu_torch.core.validators import validar_email
from ics_tpu_torch.crud import auditoria_crud, cadastro_permitido_crud, user_crud
from ics_tpu_torch.db.models import CadastroPermitido, TipoUsuario, Usuario
from ics_tpu_torch.services.auth_service import require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Response, Router

router = Router(prefix="/whitelist")


@router.post("/")
async def cadastrar_email_permitido(request: Request):
    db = request.state.db
    admin = require_admin(request)
    dados = await request.json()
    email = (dados.get("email") or "").strip().lower()
    id_tipo = dados.get("id_tipo")
    if not validar_email(email):
        raise HTTPException(422, "Email inválido.")
    if db.query(Usuario).filter(Usuario.email == email).first():
        raise HTTPException(
            400,
            "Este email já está cadastrado como usuário. Não é possível "
            "permitir novo cadastro.",
        )
    if cadastro_permitido_crud.get_cadastro_permitido_by_email(db, email):
        raise HTTPException(
            409,
            "Este email já está na whitelist. Não é possível cadastrar "
            "novamente.",
        )
    tipo = db.get(TipoUsuario, id_tipo) if id_tipo is not None else None
    if tipo is None:
        raise HTTPException(
            422, "Tipo de usuário informado é inválido. Verifique o id_tipo enviado."
        )
    adm = user_crud.get_administrador_by_usuario(db, admin.id_usu)
    novo = cadastro_permitido_crud.create_cadastro_permitido(
        db, email, tipo.id_tipo, adm.id_adm
    )
    auditoria_crud.registrar_evento(
        db, "cadastrar_email_permitido", admin.id_usu,
        {"id_cad": str(novo.id_cad), "email": novo.email},
    )
    db.commit()
    return JSONResponse(
        {
            "id_cad": str(novo.id_cad),
            "email": novo.email,
            "id_tipo": novo.id_tipo,
            "id_adm": str(novo.id_adm),
            "data_criado": novo.data_criado,
        },
        201,
    )


@router.get("/")
async def listar_cadastros_permitidos(request: Request):
    db = request.state.db
    require_admin(request)
    result = []
    for c in cadastro_permitido_crud.list_cadastros(db):
        adm_row = db.fetchone(
            """
            SELECT u.nome_completo FROM usuarios_administradores a
            JOIN usuarios u ON u.id_usu = a.id_usu WHERE a.id_adm = ?
            """,
            [c.id_adm],
        )
        result.append(
            {
                "id_cad": str(c.id_cad),
                "email": c.email,
                "id_tipo": c.id_tipo,
                "id_adm": str(c.id_adm),
                "nome_administrador": (
                    adm_row["nome_completo"] if adm_row else "(desconhecido)"
                ),
                "data_criado": c.data_criado,
                "usado": c.usado,
                "data_expiracao": c.data_expiracao,
                "ativo": c.ativo,
            }
        )
    return JSONResponse(result)


@router.delete("/{id_cad}")
async def excluir_cadastro_permitido(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_cad = request.path_params["id_cad"]
    cadastro = db.get(CadastroPermitido, id_cad)
    if cadastro is None or not cadastro.ativo:
        raise HTTPException(404, "Cadastro permitido não encontrado ou já inativo.")
    cadastro.ativo = False
    auditoria_crud.registrar_evento(
        db, "excluir_cadastro_permitido", admin.id_usu, {"id_cad": id_cad}
    )
    db.commit()
    return Response(b"", 204)


@router.patch("/{id_cad}/reativar")
async def reativar_cadastro_permitido(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_cad = request.path_params["id_cad"]
    cadastro = db.get(CadastroPermitido, id_cad)
    if cadastro is None or cadastro.ativo:
        raise HTTPException(404, "Cadastro permitido não encontrado ou já ativo.")
    cadastro.ativo = True
    auditoria_crud.registrar_evento(
        db, "reativar_cadastro_permitido", admin.id_usu, {"id_cad": id_cad}
    )
    db.commit()
    return JSONResponse({"message": "Cadastro permitido reativado com sucesso."})
