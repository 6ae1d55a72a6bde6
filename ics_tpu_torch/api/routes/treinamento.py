"""Fine-tune management routes of the port (counterpart of
``ics_tpu/api/routes/treinamento.py``: the same 13 routes, admin gate, audit
events, status codes and payloads). These admin routes close the loop:
specialist labels -> fine-tune job (``train.job.TrainingJobManager``, on the
card) -> versioned registry -> ``classificar-tpu`` serving.

- ``POST /treinamento/ambiente/{id_amb}`` — start a fine-tune job
- ``GET /treinamento/ambiente/{id_amb}/dataset`` — the labelled set as JSONL
- ``GET /treinamento/jobs`` / ``GET /treinamento/jobs/{id_job}`` — progress;
  ``.../stream`` as Server-Sent Events; ``POST .../cancelar``
- ``POST /treinamento/gc`` — delete unreferenced checkpoint dirs
- ``GET /treinamento/modelos`` — trained-model registry listing
- ``GET /treinamento/modelos/{id_mod}/exportar`` and
  ``POST /treinamento/ambiente/{id_amb}/importar`` — move a version
- ``POST /treinamento/modelos/{id_mod}/sugerir`` — bulk suggestions
- ``POST /treinamento/modelos/{id_mod}/avaliar`` — re-evaluate a version
- ``POST /treinamento/modelos/{id_mod}/ativar`` — promote a version

One answer the reference does not give: ``sugerir`` on a version the JAX
trainer wrote (orbax steps alone) is a 503 naming ``convert_checkpoints.py``,
as ``classificar-tpu`` answers it.
"""

from __future__ import annotations

from ics_tpu_torch.crud import auditoria_crud, modelo_crud
from ics_tpu_torch.db.models import Ambiente
from ics_tpu_torch.services.auth_service import require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/treinamento")


def _trainer(request: Request):
    trainer = request.app.state.get("trainer")
    if trainer is None:
        raise HTTPException(
            503,
            "Serviço de treinamento indisponível (inferência desabilitada ou "
            "NextCloud não configurado).",
        )
    return trainer


def _modelo_out(m) -> dict:
    return {
        "id_mod": str(m.id_mod),
        "id_amb": str(m.id_amb),
        "modelo": m.nome_modelo,
        "versao": m.versao,
        "num_classes": m.num_classes,
        "passo": m.passo,
        "metricas": m.metricas,
        "ativo": m.ativo,
        "data_criado": m.data_criado,
    }


@router.post("/ambiente/{id_amb}")
async def iniciar_treinamento(request: Request):
    """Start a fine-tune job on the ambiente's specialist labels (admin)."""
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None or not ambiente.ativo:
        raise HTTPException(404, "Ambiente não encontrado ou inativo.")
    trainer = _trainer(request)
    raw = await request.body()
    body = (await request.json()) if raw else {}
    modelo = body.get("modelo") or "resnet50"
    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.train.job import TrainingUnavailable

    try:
        max_steps = int(body.get("max_steps") or 100)
        batch_size = int(body.get("batch_size") or 32)
        # "is not None", not "or": an explicit lr of 0.0 is falsy and must
        # not silently become the default (same pattern as eval_fraction)
        lr = float(body.get("lr") if body.get("lr") is not None else 0.01)
        epochs = int(body.get("epochs") or 10)
        canvas = int(body.get("canvas") or settings.TPU_CANVAS)
        eval_fraction = float(
            body.get("eval_fraction")
            if body.get("eval_fraction") is not None else 0.2
        )
        sugestao_min_score = float(
            body.get("sugestao_min_score")
            if body.get("sugestao_min_score") is not None else 0.9
        )
    except (TypeError, ValueError) as exc:
        raise HTTPException(422, f"Parâmetro numérico inválido: {exc}")
    for flag_name in ("remat", "usar_sugestoes", "treinar_apenas_cabeca"):
        if not isinstance(body.get(flag_name, False), bool):
            # bool("false") is True — reject instead of silently enabling
            raise HTTPException(
                422, f"Parâmetro inválido: {flag_name} deve ser booleano"
            )
    remat = body.get("remat", False)
    usar_sugestoes = body.get("usar_sugestoes", False)
    treinar_apenas_cabeca = body.get("treinar_apenas_cabeca", False)
    # augmentation defaults ON (on-device crop/flip — ops/augment.py);
    # mixup/label-smoothing stay opt-in and require it
    if not isinstance(body.get("augmentar", True), bool):
        raise HTTPException(
            422, "Parâmetro inválido: augmentar deve ser booleano"
        )
    augmentar = body.get("augmentar", True)
    try:
        mixup_alpha = float(body.get("mixup_alpha") or 0.0)
        cutmix_alpha = float(body.get("cutmix_alpha") or 0.0)
        suavizacao_rotulo = float(body.get("suavizacao_rotulo") or 0.0)
    except (TypeError, ValueError) as exc:
        raise HTTPException(422, f"Parâmetro numérico inválido: {exc}")
    agenda_lr = body.get("agenda_lr", "cosseno")
    if not isinstance(agenda_lr, str):
        raise HTTPException(
            422, "Parâmetro inválido: agenda_lr deve ser 'cosseno' ou "
                 "'constante'"
        )
    otimizador = body.get("otimizador", "sgd")
    if not isinstance(otimizador, str):
        raise HTTPException(
            422, "Parâmetro inválido: otimizador deve ser 'sgd' ou 'adamw'"
        )
    try:
        ema_decaimento = float(body.get("ema_decaimento") or 0.0)
        # NOT `or 1`: a literal 0 must reach the >= 1 validation (422),
        # not silently become the default
        raw_accum = body.get("acumular_gradientes")
        acumular_gradientes = 1 if raw_accum is None else int(raw_accum)
        # early stopping: paciencia=0 (default) disables; avaliar_cada
        # defaults job-side to max_steps//5 when paciencia is on
        raw_pac = body.get("paciencia")
        paciencia = 0 if raw_pac is None else int(raw_pac)
        raw_aval = body.get("avaliar_cada")
        avaliar_cada = None if raw_aval is None else int(raw_aval)
        # layer-wise LR decay: head gets full LR, each block toward the
        # input gets llrd x less (the pretrained fine-tune recipe)
        llrd = float(body.get("llrd") or 0.0)
    except (TypeError, ValueError) as exc:
        raise HTTPException(422, f"Parâmetro numérico inválido: {exc}")
    retomar_de = body.get("retomar_de")
    if retomar_de is not None and not isinstance(retomar_de, str):
        raise HTTPException(422, "Parâmetro inválido: retomar_de deve ser o id de um job")
    pesos_iniciais = body.get("pesos_iniciais")
    if pesos_iniciais is not None and not isinstance(pesos_iniciais, str):
        raise HTTPException(
            422,
            "Parâmetro inválido: pesos_iniciais deve ser um nome de arquivo "
            "em {TPU_WEIGHTS_DIR}/pretrained/ ou um caminho absoluto",
        )
    try:
        job = trainer.start(
            id_amb=str(id_amb),
            model_name=modelo,
            max_steps=max_steps,
            batch_size=batch_size,
            lr=lr,
            epochs=epochs,
            canvas=canvas,
            compute_dtype=settings.TPU_PRECISION,
            eval_fraction=eval_fraction,
            remat=remat,
            usar_sugestoes=usar_sugestoes,
            sugestao_min_score=sugestao_min_score,
            retomar_de=retomar_de,
            pesos_iniciais=pesos_iniciais,
            augmentar=augmentar,
            mixup_alpha=mixup_alpha,
            cutmix_alpha=cutmix_alpha,
            suavizacao_rotulo=suavizacao_rotulo,
            agenda_lr=agenda_lr,
            treinar_apenas_cabeca=treinar_apenas_cabeca,
            otimizador=otimizador,
            ema_decaimento=ema_decaimento,
            acumular_gradientes=acumular_gradientes,
            paciencia=paciencia,
            avaliar_cada=avaliar_cada,
            llrd=llrd,
        )
    except KeyError:
        raise HTTPException(422, f"Modelo desconhecido: {modelo}.")
    except ValueError as exc:
        raise HTTPException(422, f"Parâmetro inválido: {exc}")
    except FileNotFoundError as exc:
        raise HTTPException(422, str(exc))
    except TrainingUnavailable as exc:
        raise HTTPException(503, str(exc))
    except RuntimeError as exc:
        raise HTTPException(409, str(exc))
    auditoria_crud.registrar_evento(
        db, "iniciar_treinamento", admin.id_usu,
        {"id_amb": str(id_amb), "modelo": modelo, "id_job": job.id_job},
    )
    db.commit()
    return JSONResponse(job.to_dict(), 202)


@router.get("/ambiente/{id_amb}/dataset")
async def exportar_dataset(request: Request):
    """Export the ambiente's labeled dataset as streaming JSONL (admin):
    line 1 is a metadata header (ambiente, option catalogue, counts),
    then one line per labeled image — content_hash, download path
    (the /nextcloud/images proxy), and ALL its active labels (id_opc +
    texto). The portable twin of the model export: reproduce a
    fine-tune anywhere, audit the label distribution, or hand the
    dataset to an external training stack."""
    import json as _json

    from ics_tpu_torch.core import timezone as tz
    from ics_tpu_torch.web import StreamingResponse

    db = request.state.db
    require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None:
        raise HTTPException(404, "Ambiente não encontrado.")
    opcoes = db.fetchall(
        "SELECT id_opc, texto FROM opcoes WHERE id_amb = ? ORDER BY texto",
        [str(id_amb)],
    )
    textos = {str(r["id_opc"]): r["texto"] for r in opcoes}
    # the SAME query/grouping training consumes (multi-label form keeps
    # EVERY active label per image) — the export cannot diverge from
    # what a fine-tune would actually see
    from ics_tpu_torch.train.data import inverse_map, labeled_examples

    examples, class_map = labeled_examples(
        request.app.state.db, str(id_amb), multi_label=True
    )
    inv = inverse_map(class_map)

    def lines():
        yield _json.dumps({
            "ambiente": str(id_amb),
            "titulo": ambiente.titulo_amb,
            "multipla_escolha": bool(ambiente.multipla_escolha),
            "opcoes": [{"id_opc": str(r["id_opc"]), "texto": r["texto"]}
                       for r in opcoes],
            "imagens_rotuladas": len(examples),
            "exportado_em": tz.utcnow().isoformat(),
        }, ensure_ascii=False).encode() + b"\n"
        for ex in examples:
            row = {
                "content_hash": ex["content_hash"],
                "caminho": "/nextcloud/images/"
                           + ex["caminho_img"].lstrip("/"),
                "rotulos": [
                    {"id_opc": inv[i], "texto": textos.get(inv[i])}
                    for i in ex["labels"]
                ],
            }
            yield _json.dumps(row, ensure_ascii=False).encode() + b"\n"

    return StreamingResponse(
        lines(), media_type="application/x-ndjson",
        headers={"content-disposition":
                 f"attachment; filename=dataset_{id_amb}.jsonl"},
    )


@router.get("/jobs")
async def listar_jobs(request: Request):
    require_admin(request)
    return JSONResponse({"jobs": _trainer(request).list_jobs()})


@router.get("/jobs/{id_job}")
async def status_job(request: Request):
    require_admin(request)
    job = _trainer(request).get(request.path_params["id_job"])
    if job is None:
        raise HTTPException(404, "Job de treinamento não encontrado.")
    return JSONResponse(job.to_dict())


@router.get("/jobs/{id_job}/stream")
async def stream_job(request: Request):
    """Live job progress as Server-Sent Events (admin): one ``passo``
    event per training step already recorded plus each new one as it
    lands, then a final ``fim`` event with the complete job payload when
    the job reaches a terminal state. Rides the framework's
    StreamingResponse (chunked body, connection-close delimited) — no
    polling loop needed client-side:

        const es = new EventSource('/treinamento/jobs/<id>/stream');
        es.addEventListener('passo', e => ...JSON.parse(e.data)...);
        es.addEventListener('fim',   e => es.close());
    """
    import asyncio
    import json as _json

    require_admin(request)
    job = _trainer(request).get(request.path_params["id_job"])
    if job is None:
        raise HTTPException(404, "Job de treinamento não encontrado.")

    async def events():
        # SSE comment first: flushes headers so EventSource fires `open`
        # before the first step lands
        yield b": progresso do job " + job.id_job.encode() + b"\n\n"
        sent = 0

        def drain():
            nonlocal sent
            out = []
            hist = job.history  # appended by the worker thread (on_step)
            while sent < len(hist):
                out.append(
                    ("event: passo\ndata: "
                     + _json.dumps(hist[sent]) + "\n\n").encode()
                )
                sent += 1
            return out

        while True:
            for chunk in drain():
                yield chunk
            if job.status not in ("pendente", "executando"):
                # the worker can append final steps AND flip the status
                # between the drain above and this check — drain once
                # more so no passo is silently swallowed before fim
                for chunk in drain():
                    yield chunk
                yield (
                    "event: fim\ndata: "
                    + _json.dumps(job.to_dict()) + "\n\n"
                ).encode()
                return
            await asyncio.sleep(0.25)

    from ics_tpu_torch.web import StreamingResponse

    return StreamingResponse(
        events(), media_type="text/event-stream",
        headers={"cache-control": "no-cache"},
    )


@router.post("/jobs/{id_job}/cancelar")
async def cancelar_job(request: Request):
    """Cooperative cancel: the job stops between steps (status
    ``cancelado``); nothing is registered or promoted, the last
    checkpoint stays on disk."""
    admin = require_admin(request)
    db = request.state.db
    id_job = request.path_params["id_job"]
    try:
        job = _trainer(request).cancel(id_job)
    except KeyError:
        raise HTTPException(404, "Job de treinamento não encontrado.")
    except RuntimeError as exc:
        raise HTTPException(409, str(exc))
    auditoria_crud.registrar_evento(
        db, "cancelar_treinamento", admin.id_usu,
        {"id_job": id_job, "id_amb": job.id_amb, "modelo": job.model_name},
    )
    return JSONResponse(
        {"message": "Cancelamento solicitado.", "id_job": id_job,
         "status": job.status},
        202,
    )


@router.post("/gc")
async def gc_checkpoints(request: Request):
    """Delete checkpoint dirs of cancelled/failed/superseded jobs that no
    registry version references (admin). Registry dirs always survive."""
    admin = require_admin(request)
    db = request.state.db
    import asyncio

    result = await asyncio.get_running_loop().run_in_executor(
        None, _trainer(request).gc_checkpoints
    )
    auditoria_crud.registrar_evento(
        db, "gc_treinamento", admin.id_usu,
        {"removidos": len(result["removidos"])},
    )
    return JSONResponse(result)


@router.get("/modelos")
async def listar_modelos_treinados(request: Request):
    require_admin(request)
    db = request.state.db
    id_amb = request.query_params.get("id_amb")
    rows = modelo_crud.listar_modelos(db, id_amb=id_amb)
    return JSONResponse(
        {"modelos": [_modelo_out(m) for m in rows], "total": len(rows)}
    )


@router.get("/modelos/{id_mod}/exportar")
async def exportar_modelo(request: Request):
    """Download a registry version as a portable .tar.gz (admin). Class
    indices travel with the OPTION TEXTS so another deployment can rebind
    them to its own option ids on import."""
    db = request.state.db
    require_admin(request)
    row = modelo_crud.get_modelo(db, request.path_params["id_mod"])
    if row is None:
        raise HTTPException(404, "Modelo treinado não encontrado.")
    from ics_tpu_torch.train.export import pack_model
    from ics_tpu_torch.web import Response

    data = pack_model(db, row)
    return Response(
        data,
        media_type="application/gzip",
        headers={
            "content-disposition": (
                f'attachment; filename="modelo_{row.nome_modelo}'
                f'_v{row.versao}.tar.gz"'
            )
        },
    )


@router.post("/ambiente/{id_amb}/importar")
async def importar_modelo(request: Request):
    """Import an exported model package into this ambiente (admin).

    Classes rebind by option text; 422 when the target ambiente lacks one
    of the exported options. ``?ativar=false`` registers without promoting.
    """
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None or not ambiente.ativo:
        raise HTTPException(404, "Ambiente não encontrado ou inativo.")
    form = await request.form()
    files = form.getfiles("file") or form.getfiles("files")
    if not files:
        raise HTTPException(422, "Envie o pacote no campo 'file'.")
    ativar = (request.query_params.get("ativar") or "true").lower() != "false"
    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.train.export import ImportError_, unpack_model

    try:
        row = unpack_model(
            db, files[0].data, id_amb, settings.TPU_WEIGHTS_DIR,
            ativar=ativar,
        )
    except ImportError_ as exc:
        raise HTTPException(422, f"Importação falhou: {exc}")
    auditoria_crud.registrar_evento(
        db, "importar_modelo_treinado", admin.id_usu,
        {"id_mod": str(row.id_mod), "id_amb": str(id_amb),
         "versao": row.versao, "ativado": ativar},
    )
    db.commit()
    return JSONResponse(_modelo_out(row), 201)


@router.post("/modelos/{id_mod}/sugerir")
async def sugerir_em_lote(request: Request):
    """Bulk suggestion refresh (admin): classify every synced image of the
    model's ambiente that lacks a suggestion from THIS version and persist
    the results. Closes the promotion gap — classify-on-sync only sees
    newly synced images, so after promoting v(N) the corpus would keep
    v(N-1) suggestions until each image was re-uploaded.

    Body ``{"limite": N}`` caps the pass (default 500); repeat until
    ``pendentes`` hits 0. Batches run at the engine's largest bucket."""
    import asyncio

    db = request.state.db
    admin = require_admin(request)
    row = modelo_crud.get_modelo(db, request.path_params["id_mod"])
    if row is None:
        raise HTTPException(404, "Modelo treinado não encontrado.")
    pool = request.app.state.get("engine_pool")
    if pool is None:
        raise HTTPException(503, "Serviço de inferência indisponível.")
    trainer = request.app.state.get("trainer")
    fetch = getattr(trainer, "fetch_bytes", None) if trainer else None
    if fetch is None:
        raise HTTPException(
            503, "Sem fonte de bytes (NextCloud não configurado)."
        )
    raw = await request.body()
    body = (await request.json()) if raw else {}
    try:
        limite = max(1, min(int((body or {}).get("limite", 500)), 5000))
    except (TypeError, ValueError) as exc:
        raise HTTPException(422, f"Parâmetro numérico inválido: {exc}")

    from ics_tpu_torch.train.checkpoint import CONVERSION_TOOL, UnconvertedCheckpointError

    try:
        service = await pool.get_trained(row)
    except UnconvertedCheckpointError as exc:
        raise HTTPException(
            503, f"A versão {row.versao} do modelo treinado foi gravada pelo "
                 f"treinador JAX (orbax) e ainda não foi convertida: execute "
                 f"`python {CONVERSION_TOOL} {exc.directory}`.")
    engine = service.engine
    inv = modelo_crud.inverse_class_map(row)
    metricas = row.metricas or {}
    pend = modelo_crud.imagens_sem_sugestao(
        db, str(row.id_amb), row.versao, limit=limite
    )

    from ics_tpu_torch.db.models import Opcao
    from ics_tpu_torch.runtime.decode import decode_image, stage_batch

    texto_cache: dict[str, str] = {}

    def run_batches() -> tuple[int, int]:
        feitas = falhas = 0
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
            idx, scores = engine.predict_staged(canvas, sizes)
            with request.app.state.db.session() as s:
                for h, row_idx, row_scores in zip(hashes, idx, scores):
                    opcoes_out = []
                    for cls, sc in zip(row_idx, row_scores):
                        id_opc = inv.get(int(cls))
                        if id_opc is None:
                            continue  # padding class beyond the options
                        if id_opc not in texto_cache:
                            opc = s.get(Opcao, id_opc)
                            texto_cache[id_opc] = opc.texto if opc else None
                        opcoes_out.append(
                            {
                                "id_opc": id_opc,
                                "texto_opcao": texto_cache[id_opc],
                                "score": float(sc),
                            }
                        )
                    if not opcoes_out:
                        falhas += 1
                        continue
                    modelo_crud.registrar_sugestao(
                        s, h,
                        modelo=row.nome_modelo,
                        classes=opcoes_out,
                        score=opcoes_out[0]["score"],
                        id_amb=str(row.id_amb),
                        id_mod=str(row.id_mod),
                        id_opc=opcoes_out[0]["id_opc"],
                        versao=row.versao,
                    )
                    feitas += 1
                s.commit()
        return feitas, falhas

    loop = asyncio.get_running_loop()
    sugeridas, falhas = await loop.run_in_executor(None, run_batches)
    restantes = len(
        modelo_crud.imagens_sem_sugestao(
            db, str(row.id_amb), row.versao, limit=1
        )
    )
    auditoria_crud.registrar_evento(
        db, "sugestoes_em_lote", admin.id_usu,
        {
            "id_mod": str(row.id_mod), "versao": row.versao,
            "sugeridas": sugeridas, "falhas": falhas,
        },
    )
    db.commit()
    return JSONResponse(
        {
            "id_mod": str(row.id_mod),
            "versao": row.versao,
            "multi_rotulo": bool(metricas.get("multi_rotulo")),
            "sugeridas": sugeridas,
            "falhas": falhas,
            "pendentes": restantes,
        }
    )


@router.post("/modelos/{id_mod}/avaliar")
async def reavaliar_modelo(request: Request):
    """Re-evaluate a registry version against the ambiente's CURRENT
    human labels (admin; 202 + job). Labels accumulate after training —
    fresh accuracy + per-class diagnostics land in the job result and in
    ``metricas.reavaliacao`` (the previous re-evaluation is kept as
    ``reavaliacao_anterior``). Eval-only: weights unchanged, nothing is
    promoted. One job at a time (409), like training."""
    db = request.state.db
    admin = require_admin(request)
    trainer = _trainer(request)
    id_mod = request.path_params["id_mod"]
    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.train.job import TrainingUnavailable

    try:
        job = trainer.start_evaluation(
            id_mod,
            canvas=int(settings.TPU_CANVAS),
            compute_dtype=settings.TPU_PRECISION,
        )
    except KeyError:
        raise HTTPException(404, "Modelo treinado não encontrado.")
    except TrainingUnavailable as exc:
        raise HTTPException(503, str(exc))
    except RuntimeError as exc:
        raise HTTPException(409, str(exc))
    auditoria_crud.registrar_evento(
        db, "reavaliar_modelo_treinado", admin.id_usu,
        {"id_mod": str(id_mod), "id_job": job.id_job},
    )
    db.commit()
    return JSONResponse(job.to_dict(), 202)


@router.post("/modelos/{id_mod}/ativar")
async def ativar_modelo_treinado(request: Request):
    """Promote a registry version to serving for its ambiente (admin)."""
    db = request.state.db
    admin = require_admin(request)
    row = modelo_crud.ativar_modelo(db, request.path_params["id_mod"])
    if row is None:
        raise HTTPException(404, "Modelo treinado não encontrado.")
    auditoria_crud.registrar_evento(
        db, "ativar_modelo_treinado", admin.id_usu,
        {"id_mod": str(row.id_mod), "id_amb": str(row.id_amb),
         "versao": row.versao},
    )
    db.commit()
    return JSONResponse(_modelo_out(row))
