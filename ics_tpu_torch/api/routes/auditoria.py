"""Audit-log routes (reference: ``app/api/routes/auditoria.py``)."""

from __future__ import annotations

from ics_tpu_torch.crud import auditoria_crud
from ics_tpu_torch.services.auth_service import require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/auditoria")


@router.get("/logs")
async def listar_logs(request: Request):
    db = request.state.db
    require_admin(request)
    page = request.query_int("page", 1, lo=1)
    page_size = request.query_int("page_size", 50, lo=1, hi=200)
    id_usuario = request.query_params.get("id_usuario")
    id_evento_raw = request.query_params.get("id_evento")
    id_evento = None
    if id_evento_raw:
        try:
            id_evento = int(id_evento_raw)
        except ValueError:
            raise HTTPException(422, "Parâmetro 'id_evento' deve ser inteiro")
    rows, total = auditoria_crud.listar_logs(
        db,
        id_usu=id_usuario,
        evento_id=id_evento,
        page=page,
        page_size=page_size,
        data_inicio=request.query_params.get("data_inicio"),
        data_fim=request.query_params.get("data_fim"),
    )
    logs = [
        {
            "id_log": str(r["id_log"]),
            "id_usu": str(r["id_usu"]),
            "nome_usuario": r.get("usuario_nome") or "(desconhecido)",
            "id_evento": r["evento_id"],
            "nome_evento": r["evento_nome"],
            "data_evento": r["data_evento"],
            "detalhes": r["detalhes"] or {},
        }
        for r in rows
    ]
    return JSONResponse(
        {
            "logs": logs,
            "page": page,
            "page_size": page_size,
            "total": total,
            "is_last_page": (page * page_size) >= total,
        }
    )


@router.get("/eventos")
async def listar_eventos(request: Request):
    db = request.state.db
    require_admin(request)
    return JSONResponse(
        [
            {"id_evento": e.id_evento, "nome": e.nome, "descricao": e.descricao}
            for e in auditoria_crud.listar_eventos(db)
        ]
    )
