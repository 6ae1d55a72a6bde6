"""Inference routes of the port (counterpart of ``ics_tpu/api/routes/inferencia.py``).

- ``GET /inferencia/modelos`` — ported models (any authenticated user)
- ``GET /inferencia/status`` — engine, batcher, latency and kernel-launch
  counts (admin); ``?modelo=`` reads a model the pool has built
- ``POST /inferencia/warmup`` — run every batch bucket once on every
  replica (admin)
- ``POST /inferencia/classificar`` — multipart image(s) -> top-k classes
  and scores (authenticated); ``?modelo=`` picks another ported model
- ``POST /inferencia/kernels/zerar`` — set the kernel-launch counts to 0
  and return what they were (admin): a window over which the counts say
  which kernels a stretch of traffic ran
- ``POST /inferencia/indexar`` — backfill the embeddings of synced images
  the default model has none of (admin), the bytes read through
  ``app.state.trainer.fetch_bytes``
- ``POST /inferencia/profiler/start|stop`` — a ``torch.profiler`` trace (admin)
"""

from __future__ import annotations

import asyncio
import os
import tempfile

from ics_tpu_torch.services.auth_service import get_current_user, require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router
from ics_tpu_torch.models.registry import get_model, list_models
from ics_tpu_torch.ops import reset_launch_counts

router = Router(prefix="/inferencia")

_profiler: dict = {"active": None}


def _profile_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "ics_tpu_torch_profile")


def _engine(request: Request):
    engine = request.app.state.get("engine")
    if engine is None:
        raise HTTPException(503, "Serviço de inferência indisponível.")
    return engine


@router.get("/modelos")
async def listar_modelos(request: Request):
    get_current_user(request)
    out = []
    for name in list_models(include_dev=False):
        spec = get_model(name)
        out.append({
            "nome": name,
            "image_size": spec.image_size,
            "resize_short": spec.resize_short,
            "descricao": spec.description,
        })
    return JSONResponse({"modelos": out, "total": len(out)})


@router.get("/status")
async def status_inferencia(request: Request):
    require_admin(request)
    modelo = request.query_params.get("modelo")
    pool = request.app.state.get("engine_pool")
    if modelo and pool is not None:
        service = pool.built(modelo)
        if service is None:
            raise HTTPException(404, f"Modelo não carregado: {modelo}.")
        return JSONResponse(service.status())
    return JSONResponse(_engine(request).status())


@router.post("/warmup")
async def warmup(request: Request):
    require_admin(request)
    service = _engine(request)
    loop = asyncio.get_running_loop()
    # under hedged serving every replica has an engine of its own
    parts = getattr(service, "replicas", [service])
    for part in parts:
        await loop.run_in_executor(None, part.engine.warmup)
    return JSONResponse({
        "message": "warmup concluído",
        "buckets": list(service.engine.buckets),
        "replicas": len(parts),
    })


@router.post("/kernels/zerar")
async def zerar_contadores(request: Request):
    require_admin(request)
    return JSONResponse({"anteriores": reset_launch_counts()})


@router.post("/classificar")
async def classificar_direto(request: Request):
    get_current_user(request)
    modelo = request.query_params.get("modelo")
    pool = request.app.state.get("engine_pool")
    if modelo and pool is not None:
        if modelo not in list_models(include_dev=False):
            raise HTTPException(
                422, f"Modelo desconhecido: {modelo}. Use /inferencia/modelos."
            )
        try:
            service = await pool.get(modelo)
        except (RuntimeError, ValueError) as exc:
            # the client picked a model this deployment cannot build (a
            # setting the model does not go with, a stopped pool): 422, not 500
            raise HTTPException(
                422, f"Modelo '{modelo}' indisponível nesta configuração: {exc}"
            )
    else:
        service = _engine(request)
    form = await request.form()
    files = [f for _, f in form.files]
    if not files:
        raise HTTPException(422, "Envie ao menos uma imagem (campo 'files').")
    try:
        results = await service.classify_many([f.data for f in files])
    except (OSError, ValueError) as exc:
        # undecodable uploads are the client's fault; anything else is a 500
        raise HTTPException(422, f"Uma ou mais imagens são inválidas: {exc}")
    return JSONResponse({"total": len(results), "resultados": results})


@router.post("/indexar")
async def indexar_embeddings(request: Request):
    """Backfill embeddings for synced images that lack one under the
    default model (admin). Body: ``{"limite": N}`` caps the pass (default
    500, clamped to 1-5000) — run repeatedly until ``pendentes`` hits 0.
    Images whose bytes can't be fetched/decoded are skipped and reported,
    not fatal. Batches ride the engine's largest bucket."""
    usuario = require_admin(request)
    service = _engine(request)
    db = request.state.db
    trainer = request.app.state.get("trainer")
    fetch = getattr(trainer, "fetch_bytes", None) if trainer else None
    if fetch is None:
        raise HTTPException(503, "Sem fonte de bytes (NextCloud não configurado).")
    try:
        body = await request.json()
    except Exception:
        body = {}
    try:
        limite = int((body or {}).get("limite", 500))
    except (TypeError, ValueError) as exc:
        raise HTTPException(422, f"Parâmetro numérico inválido: {exc}")
    limite = max(1, min(limite, 5000))
    engine = service.engine
    modelo = engine.model_name

    from ics_tpu_torch.crud import auditoria_crud
    from ics_tpu_torch.crud.embedding_crud import (
        contar_embeddings,
        hashes_sem_embedding,
        upsert_embedding,
    )
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch

    pend = hashes_sem_embedding(db, modelo, limit=limite)

    def run_batches() -> tuple[int, int]:
        done = falhas = 0
        batch = max(engine.buckets)
        for start in range(0, len(pend), batch):
            chunk = pend[start:start + batch]
            images, hashes = [], []
            for item in chunk:
                try:
                    data = fetch(item["content_hash"], item["caminho_img"])
                    images.append(decode_image(data))
                    hashes.append(item["content_hash"])
                except Exception:
                    falhas += 1
            if not images:
                continue
            canvas, sizes = stage_batch(images, canvas=None)
            feats = engine.embed_staged(canvas, sizes)
            with request.app.state.db.session() as s:
                for h, vec in zip(hashes, feats):
                    upsert_embedding(s, h, modelo, vec)
                s.commit()
            done += len(hashes)
        return done, falhas

    indexadas, falhas = await asyncio.get_running_loop().run_in_executor(None, run_batches)
    total = contar_embeddings(db, modelo)
    restantes = len(hashes_sem_embedding(db, modelo, limit=1))
    auditoria_crud.registrar_evento(
        db, "indexar_embeddings", usuario.id_usu,
        {"modelo": modelo, "indexadas": indexadas, "falhas": falhas},
    )
    db.commit()
    return JSONResponse({
        "modelo": modelo,
        "indexadas": indexadas,
        "falhas": falhas,
        "total_indexadas": total,
        "pendentes": restantes,
    })


@router.post("/profiler/start")
async def profiler_start(request: Request):
    require_admin(request)
    if _profiler["active"] is not None:
        raise HTTPException(409, "Profiler já ativo.")
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _profiler["active"] = prof
    return JSONResponse({"message": "trace iniciado", "dir": _profile_dir()})


@router.post("/profiler/stop")
async def profiler_stop(request: Request):
    require_admin(request)
    prof = _profiler["active"]
    if prof is None:
        raise HTTPException(409, "Profiler não está ativo.")
    _profiler["active"] = None
    prof.stop()
    os.makedirs(_profile_dir(), exist_ok=True)
    path = os.path.join(_profile_dir(), f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return JSONResponse({"message": "trace finalizado", "dir": _profile_dir(),
                         "arquivo": path})
