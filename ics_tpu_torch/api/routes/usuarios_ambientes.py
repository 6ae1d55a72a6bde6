"""User-ambiente association routes
(reference: ``app/api/routes/usuarios_ambientes.py``)."""

from __future__ import annotations

from ics_tpu_torch.crud import auditoria_crud, user_crud, usuarios_ambientes_crud
from ics_tpu_torch.db.models import Usuario
from ics_tpu_torch.services.auth_service import get_current_user, require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Response, Router

router = Router(prefix="/usuarios-ambientes")


def _usuario_ambientes_out(db, con, ambientes) -> dict:
    user = db.get(Usuario, con.id_usu)
    return {
        "id_con": str(con.id_con),
        "nome_completo": user.nome_completo if user else "",
        "email": user.email if user else "",
        "ambientes": ambientes,
    }


@router.get("/meus-ambientes")
async def meus_ambientes(request: Request):
    db = request.state.db
    usuario = get_current_user(request)
    con = user_crud.get_convencional_by_usuario(db, usuario.id_usu)
    if con is None:
        raise HTTPException(
            403, "Apenas usuários convencionais podem ter ambientes associados."
        )
    if not usuario.ativo:
        raise HTTPException(403, "Usuário inativo não pode acessar ambientes.")
    usuario_conv, ambientes = usuarios_ambientes_crud.listar_ambientes_usuario(
        db, str(con.id_con)
    )
    if usuario_conv is None:
        raise HTTPException(404, "Usuário convencional não encontrado.")
    return JSONResponse(_usuario_ambientes_out(db, usuario_conv, ambientes))


@router.get("/usuario/{id_con}/ambientes")
async def listar_ambientes_usuario(request: Request):
    db = request.state.db
    usuario = get_current_user(request)
    id_con = request.path_params["id_con"]
    con = user_crud.get_convencional_by_usuario(db, usuario.id_usu)
    if con is not None and str(con.id_con) != id_con:
        raise HTTPException(403, "Você só pode visualizar seus próprios ambientes.")
    usuario_conv, ambientes = usuarios_ambientes_crud.listar_ambientes_usuario(
        db, id_con
    )
    if usuario_conv is None:
        raise HTTPException(404, "Usuário convencional não encontrado ou inativo.")
    return JSONResponse(_usuario_ambientes_out(db, usuario_conv, ambientes))


@router.post("/{id_amb}/associar")
async def criar_associacoes(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    payload = await request.json()
    ambiente, associados = usuarios_ambientes_crud.criar_associacoes(
        db, id_amb, payload.get("ids_usuarios") or []
    )
    if ambiente is None:
        raise HTTPException(
            404, "Ambiente não encontrado, inativo, ou IDs de usuários inválidos."
        )
    auditoria_crud.registrar_evento(
        db, "associar_usuarios_ambiente", admin.id_usu,
        {
            "id_amb": id_amb,
            "ids_usuarios": associados,
            "total_associados": len(associados),
        },
    )
    db.commit()
    return JSONResponse(
        {
            "message": (
                f"{len(associados)} usuário(s) associado(s) ao ambiente com sucesso."
            ),
            "id_amb": id_amb,
            "ids_usuarios_associados": associados,
            "total": len(associados),
        }
    )


@router.post("/{id_amb}/associar-todos")
async def associar_todos_usuarios(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    count = usuarios_ambientes_crud.associar_todos_usuarios_ao_ambiente(db, id_amb)
    if count is None:
        raise HTTPException(404, "Ambiente não encontrado ou inativo.")
    auditoria_crud.registrar_evento(
        db, "associar_todos_usuarios_ambiente", admin.id_usu,
        {"id_amb": id_amb, "total_associados": count},
    )
    db.commit()
    return JSONResponse(
        {
            "message": f"{count} usuário(s) convencional(is) associado(s) ao ambiente.",
            "id_amb": id_amb,
            "total_associados": count,
        }
    )


@router.delete("/{id_amb}/usuario/{id_con}")
async def excluir_associacao(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    id_con = request.path_params["id_con"]
    vinculo = usuarios_ambientes_crud.excluir_associacao(db, id_con, id_amb)
    if vinculo is None:
        raise HTTPException(404, "Associação não encontrada ou já inativa.")
    auditoria_crud.registrar_evento(
        db, "excluir_associacao_usuario_ambiente", admin.id_usu,
        {"id_amb": id_amb, "id_con": id_con},
    )
    db.commit()
    return Response(b"", 204)


@router.patch("/{id_amb}/usuario/{id_con}/reativar")
async def reativar_associacao(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    id_con = request.path_params["id_con"]
    vinculo = usuarios_ambientes_crud.reativar_associacao(db, id_con, id_amb)
    if vinculo is None:
        raise HTTPException(
            404,
            "Associação não encontrada, já ativa, ou não pode ser reativada "
            "(ambiente ou usuário inativo).",
        )
    auditoria_crud.registrar_evento(
        db, "reativar_associacao_usuario_ambiente", admin.id_usu,
        {"id_amb": id_amb, "id_con": id_con},
    )
    db.commit()
    return JSONResponse(
        {
            "message": "Associação reativada com sucesso.",
            "id_amb": id_amb,
            "id_con": id_con,
        }
    )


@router.get("/ambiente/{id_amb}/usuarios")
async def listar_usuarios_do_ambiente(request: Request):
    db = request.state.db
    require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente, usuarios = usuarios_ambientes_crud.listar_usuarios_do_ambiente(
        db, id_amb
    )
    if ambiente is None:
        raise HTTPException(404, "Ambiente não encontrado.")
    return JSONResponse(
        {
            "id_amb": str(ambiente.id_amb),
            "titulo_amb": ambiente.titulo_amb,
            "descricao_questionario": ambiente.descricao_questionario,
            "ativo": ambiente.ativo,
            "usuarios": usuarios,
            "total": len(usuarios),
        }
    )
