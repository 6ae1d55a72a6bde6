"""Public sync-inspection routes (reference: ``app/api/routes/test_sync.py``)."""

from __future__ import annotations

import math

from ics_tpu_torch.db.models import ConjuntoImagens, Imagem
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/test")


def _conjunto_out(c: ConjuntoImagens) -> dict:
    return {
        "id_cnj": str(c.id_cnj),
        "nome_conj": c.nome_conj,
        "caminho_conj": c.caminho_conj,
        "file_id": c.file_id,
        "imagens_sincronizadas": c.imagens_sincronizadas,
        "existe_no_nextcloud": c.existe_no_nextcloud,
        "data_proc": c.data_proc,
        "data_sinc": c.data_sinc,
    }


@router.get("/conjuntos")
async def list_conjuntos_imagens(request: Request):
    db = request.state.db
    conjuntos = (
        db.query(ConjuntoImagens).order_by(ConjuntoImagens.data_proc.desc()).all()
    )
    return JSONResponse(
        {"conjuntos": [_conjunto_out(c) for c in conjuntos], "total": len(conjuntos)}
    )


@router.get("/conjuntos/{id_cnj}/imagens")
async def list_imagens_conjunto(request: Request):
    db = request.state.db
    id_cnj = request.path_params["id_cnj"]
    page = request.query_int("page", 1, lo=1)
    page_size = request.query_int("page_size", 50, lo=1, hi=200)
    conjunto = db.get(ConjuntoImagens, id_cnj)
    if conjunto is None:
        raise HTTPException(404, "Conjunto de imagens não encontrado.")
    total = db.query(Imagem).filter(Imagem.id_cnj == id_cnj).count()
    imagens = (
        db.query(Imagem)
        .filter(Imagem.id_cnj == id_cnj)
        .order_by(Imagem.data_proc.desc())
        .limit(page_size)
        .offset((page - 1) * page_size)
        .all()
    )
    total_pages = max(math.ceil(total / page_size), 1)
    return JSONResponse(
        {
            "imagens": [
                {
                    "content_hash": i.content_hash,
                    "nome_img": i.nome_img,
                    "caminho_img": i.caminho_img,
                    "existe_no_nextcloud": i.existe_no_nextcloud,
                    "data_proc": i.data_proc,
                    "data_sinc": i.data_sinc,
                    "metadados": i.metadados,
                }
                for i in imagens
            ],
            "page": page,
            "page_size": page_size,
            "total": total,
            "total_pages": total_pages,
            "has_next": page < total_pages,
            "has_previous": page > 1,
            "conjunto_info": _conjunto_out(conjunto),
        }
    )
