"""Public NextCloud proxy routes
(reference: ``app/api/routes/nextcloud_images.py``).

``GET /nextcloud/images`` — live paginated folder listing via PROPFIND.
``GET /nextcloud/images/{path}`` — streaming image proxy, 8 KiB chunks,
Content-Type/Length passthrough, ``Cache-Control: public, max-age=3600``.
"""

from __future__ import annotations

import logging

import httpx

from ics_tpu_torch.core.config import settings
from ics_tpu_torch.sync.nextcloud_client import get_nextcloud_client
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router
from ics_tpu_torch.web.responses import StreamingResponse

logger = logging.getLogger(__name__)

router = Router(prefix="/nextcloud")


@router.get("/images")
async def list_images(request: Request):
    folder_path = request.query_params.get("folder_path", "")
    page = request.query_int("page", 1, lo=1)
    page_size = request.query_int(
        "page_size", 50, lo=1, hi=settings.NEXTCLOUD_MAX_PAGE_SIZE
    )
    try:
        client = get_nextcloud_client()
    except ValueError as exc:
        raise HTTPException(500, f"Erro de configuração do NextCloud: {exc}")
    try:
        items = await client.list_folder(folder_path, depth=1)
    except Exception as exc:
        logger.error("erro ao listar imagens: %s", exc)
        raise HTTPException(500, f"Erro ao acessar NextCloud: {exc}")
    images = client.filter_images(items)
    total = len(images)
    total_pages = (total + page_size - 1) // page_size if total else 0
    if page > total_pages and total_pages > 0:
        raise HTTPException(
            404, f"Página {page} não existe. Total de páginas: {total_pages}"
        )
    start = (page - 1) * page_size
    page_items = images[start:start + page_size]
    return JSONResponse(
        {
            "images": [
                {
                    "name": i["name"],
                    "path": i["path"],
                    "content_type": i["content_type"],
                    "size": i.get("content_length", 0),
                    "last_modified": i.get("last_modified"),
                    "file_id": i.get("file_id", ""),
                    "etag": i.get("etag", ""),
                    "download_url": i["path"],
                }
                for i in page_items
            ],
            "page": page,
            "page_size": page_size,
            "total": total,
            "total_pages": total_pages,
            "has_next": page < total_pages,
            "has_previous": page > 1,
        }
    )


@router.get("/images/{file_path:path}")
async def get_image(request: Request):
    file_path = request.path_params["file_path"]
    try:
        client = get_nextcloud_client()
    except ValueError as exc:
        raise HTTPException(500, f"Erro de configuração do NextCloud: {exc}")
    try:
        headers, chunks = await client.stream_file(file_path, chunk_size=8192)
    except httpx.HTTPStatusError as exc:
        status = exc.response.status_code if exc.response is not None else 502
        if status == 404:
            raise HTTPException(404, "Imagem não encontrada no NextCloud.")
        raise HTTPException(502, f"Erro ao baixar imagem do NextCloud (HTTP {status}).")
    except Exception as exc:
        logger.error("erro ao baixar imagem: %s", exc)
        raise HTTPException(502, f"Erro ao acessar NextCloud: {exc}")
    out_headers = {"cache-control": "public, max-age=3600"}
    if headers.get("content-length"):
        out_headers["content-length"] = headers["content-length"]
    return StreamingResponse(
        chunks,
        media_type=headers.get("content-type", "application/octet-stream"),
        headers=out_headers,
    )
