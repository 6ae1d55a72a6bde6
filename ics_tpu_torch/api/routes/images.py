"""Public image-lookup routes (reference: ``app/api/routes/images.py``).

``buscar-por-hash`` keeps the reference's exact SHA-256 identity lookup;
``buscar-similares`` / ``{hash}/similares`` are the JAX package's net-new
tier — content similarity via backbone embeddings and an on-device cosine top-k
(the reference can only answer "is this EXACT file synced?"; these answer
"which synced images LOOK like this?", including near-duplicates that
recompression/resizing hid from the hash).
"""

from __future__ import annotations

from ics_tpu_torch.core.security import sha256_hex
from ics_tpu_torch.db.models import Imagem
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/images")


def _default_service(request: Request):
    service = request.app.state.get("engine")
    if service is None:
        raise HTTPException(503, "Serviço de inferência indisponível.")
    return service


def _embedding_index(request: Request, modelo: str):
    """Per-model index cached on app state (refresh() is version-checked,
    so sharing one instance across requests is cheap and coherent). Its
    matrix lives on the serving engine's device."""
    from ics_tpu_torch.runtime.embedding_index import EmbeddingIndex

    indexes = request.app.state.get("embedding_indexes")
    if indexes is None:
        indexes = {}
        request.app.state.embedding_indexes = indexes
    if modelo not in indexes:
        engine = _default_service(request).engine
        indexes[modelo] = EmbeddingIndex(request.app.state.db, modelo, device=engine.device)
    return indexes[modelo]


def _parse_limite(request: Request, default: int = 10, cap: int = 50) -> int:
    try:
        limite = int(request.query_params.get("limite", default))
    except (TypeError, ValueError):
        raise HTTPException(422, "limite deve ser um inteiro.")
    return max(1, min(limite, cap))


def _render_similares(db, matches: list[dict]) -> list[dict]:
    from urllib.parse import quote

    out = []
    for m in matches:
        img = db.get(Imagem, m["content_hash"])
        if img is None or not img.existe_no_nextcloud:
            continue
        out.append(
            {
                "content_hash": img.content_hash,
                "nome_img": img.nome_img,
                "caminho_img": img.caminho_img,
                # same percent-quoted proxy URL contract as the paging
                # payload (classificacoes._download_url)
                "download_url": "/nextcloud/images/"
                + quote(img.caminho_img.lstrip("/"), safe="/"),
                "score": round(m["score"], 6),
            }
        )
    return out


@router.post("/buscar-similares")
async def buscar_imagens_similares(request: Request):
    """Upload an image -> the most visually similar synced images
    (cosine over L2-normalized backbone embeddings, computed on-device).

    ``?limite=`` caps results (default 10, max 50);
    ``?apenas_duplicatas=true`` keeps only matches at or above the
    near-duplicate threshold (``TPU_DUPLICATE_THRESHOLD``, default 0.98)
    — recompressed/resized copies the exact-hash lookup cannot see."""
    from ics_tpu_torch.core.config import settings

    db = request.state.db
    service = _default_service(request)
    form = await request.form()
    files = form.getfiles("file") or form.getfiles("files")
    if not files:
        raise HTTPException(422, "Envie a imagem no campo 'file'.")
    limite = _parse_limite(request)
    apenas_dup = (
        str(request.query_params.get("apenas_duplicatas", "")).lower()
        in ("1", "true", "sim")
    )
    try:
        query = await service.embed_bytes(files[0].data)
    except (OSError, ValueError):
        raise HTTPException(422, "Imagem inválida ou não decodificável.")
    modelo = service.engine.model_name
    index = _embedding_index(request, modelo)
    min_score = settings.TPU_DUPLICATE_THRESHOLD if apenas_dup else None
    content_hash = sha256_hex(files[0].data)
    import asyncio

    # a query that IS a synced image excludes itself (its own stored
    # embedding would trivially top the list at ~1.0); the device top-k
    # (and a possible index refresh) runs off the event loop
    matches = await asyncio.get_running_loop().run_in_executor(
        None,
        lambda: index.search(
            query, k=limite, exclude=content_hash, min_score=min_score
        ),
    )
    return JSONResponse(
        {"hash_consulta": content_hash, "modelo": modelo}
        | _render_payload(db, matches)
    )


def _render_payload(db, matches: list[dict]) -> dict:
    similares = _render_similares(db, matches)
    return {"total": len(similares), "similares": similares}


@router.get("/{content_hash}/similares")
async def similares_por_hash(request: Request):
    """Nearest neighbours of an already-synced image by its stored
    embedding (404 until the image has been indexed)."""
    from ics_tpu_torch.crud.embedding_crud import get_embedding

    db = request.state.db
    service = _default_service(request)
    content_hash = request.path_params["content_hash"]
    limite = _parse_limite(request)
    modelo = service.engine.model_name
    vec = get_embedding(db, content_hash, modelo)
    if vec is None:
        raise HTTPException(
            404,
            "Imagem sem embedding indexado para o modelo atual. "
            "Use POST /inferencia/indexar.",
        )
    index = _embedding_index(request, modelo)
    import asyncio

    matches = await asyncio.get_running_loop().run_in_executor(
        None, lambda: index.search(vec, k=limite, exclude=content_hash)
    )
    return JSONResponse(
        {"content_hash": content_hash, "modelo": modelo}
        | _render_payload(db, matches)
    )


@router.post("/buscar-por-hash")
async def buscar_imagens_por_hash(request: Request):
    db = request.state.db
    form = await request.form()
    files = [f for _, f in form.files]
    if not files:
        raise HTTPException(
            400, "Nenhuma imagem foi enviada. Envie pelo menos uma imagem."
        )
    resultados = []
    total_encontradas = 0
    for f in files:
        if not f.content_type.startswith("image/"):
            resultados.append({"hash": "", "encontrada": False, "imagem": None})
            continue
        content_hash = sha256_hex(f.data)
        imagem = db.get(Imagem, content_hash)
        if imagem is not None:
            total_encontradas += 1
            resultados.append(
                {
                    "hash": content_hash,
                    "encontrada": True,
                    "imagem": {
                        "content_hash": imagem.content_hash,
                        "nome_img": imagem.nome_img,
                        "caminho_img": imagem.caminho_img,
                    },
                }
            )
        else:
            resultados.append(
                {"hash": content_hash, "encontrada": False, "imagem": None}
            )
    return JSONResponse(
        {
            "total_enviadas": len(files),
            "total_encontradas": total_encontradas,
            "resultados": resultados,
        }
    )
