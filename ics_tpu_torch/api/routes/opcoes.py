"""Option routes (reference: ``app/api/routes/opcoes.py``)."""

from __future__ import annotations

from ics_tpu_torch.crud import auditoria_crud, opcao_crud
from ics_tpu_torch.services.auth_service import get_current_user, require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/opcoes")


@router.post("/ambiente/{id_amb}")
async def criar_opcao(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    dados = await request.json()
    nova = opcao_crud.criar_opcao(db, id_amb, dados.get("texto") or "")
    if nova is None:
        raise HTTPException(
            400,
            "Não foi possível criar a opção. Verifique se o ambiente está "
            "ativo, se o texto é válido (1-255 caracteres) e se não há opção "
            "duplicada.",
        )
    auditoria_crud.registrar_evento(
        db, "criar_opcao", admin.id_usu,
        {"id_opc": str(nova.id_opc), "id_amb": id_amb, "texto": nova.texto},
    )
    db.commit()
    return JSONResponse(
        {"id_opc": str(nova.id_opc), "texto": nova.texto, "id_amb": str(nova.id_amb)},
        201,
    )


@router.get("/ambiente/{id_amb}")
async def listar_opcoes_ambiente(request: Request):
    db = request.state.db
    get_current_user(request)
    id_amb = request.path_params["id_amb"]
    ambiente, opcoes = opcao_crud.listar_opcoes_ambiente(db, id_amb)
    if ambiente is None:
        raise HTTPException(404, "Ambiente não encontrado.")
    out = [
        {"id_opc": str(o.id_opc), "texto": o.texto, "id_amb": str(o.id_amb)}
        for o in opcoes
    ]
    return JSONResponse(
        {
            "id_amb": str(ambiente.id_amb),
            "titulo_amb": ambiente.titulo_amb,
            "opcoes": out,
            "total": len(out),
        }
    )
