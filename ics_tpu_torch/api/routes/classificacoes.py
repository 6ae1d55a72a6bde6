"""Classification routes — the core product loop
(reference: ``app/api/routes/classificacoes.py``).

Endpoint-for-endpoint parity: inicializar/avancar/voltar (keyset paging,
20/page), classificar (multi-option delta), contagem, per-image lookup,
historico, the active-learning page ``priorizadas``, and the kNN vote
``sugerir-vizinhos`` over the embedding index. Model inference under the
same surface: ``classificar-tpu`` (``?tta=``) and the saliency map
``explicar`` (``?id_opc=``, ``?suavizar=``), served by the ambiente's active
trained version where it has one.

One answer differs from the reference's: ``explicar`` on a model whose path
runs a kernel with no backward (ViT's flash attention, ResNet's fused
chains) is a 422, as the reference's, whose gradient fails as a bad image
would, but its message says that explain is not available for that model's
kernels.
"""

from __future__ import annotations

from typing import Optional
from urllib.parse import quote

from ics_tpu_torch.crud import classificacao_crud
from ics_tpu_torch.db.models import Classificacao, Imagem, Opcao, UsuarioAmbiente, Ambiente
from ics_tpu_torch.services import auth_service
from ics_tpu_torch.train.checkpoint import CONVERSION_TOOL, UnconvertedCheckpointError
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Router

router = Router(prefix="/classificacoes")

PAGE = 20


def _obter_id_con_usuario(db, usuario) -> str:
    from ics_tpu_torch.crud.user_crud import get_convencional_by_usuario

    con = get_convencional_by_usuario(db, usuario.id_usu)
    if con is None:
        raise HTTPException(
            403, "Apenas usuários convencionais podem classificar imagens."
        )
    return str(con.id_con)


def _verificar_acesso_ambiente(db, id_con: str, id_amb: str) -> bool:
    assoc = db.get(UsuarioAmbiente, str(id_con), str(id_amb))
    if assoc is None or not assoc.ativo:
        return False
    ambiente = db.get(Ambiente, str(id_amb))
    return ambiente is not None and ambiente.ativo


def _require_acesso(db, id_con: str, id_amb: str) -> None:
    if not _verificar_acesso_ambiente(db, id_con, id_amb):
        raise HTTPException(
            403, "Você não tem acesso a este ambiente ou o ambiente está inativo."
        )


def _classificacao_info(db, c: Classificacao) -> dict:
    opcao = db.get(Opcao, c.id_opc)
    return {
        "id_cla": str(c.id_cla),
        "id_opc": str(c.id_opc),
        "texto_opcao": opcao.texto if opcao else "Opção não encontrada",
        "data_criado": c.data_criado,
        "data_modificado": c.data_modificado,
    }


def _download_url(caminho_img: str) -> str:
    return f"/nextcloud/images/{quote(caminho_img.lstrip('/'), safe='/')}"


def _montar_resposta_imagens(
    db, imagens, id_con: str, tem_mais: bool, id_amb: Optional[str] = None
) -> dict:
    if not imagens:
        return {"imagens": [], "total": 0, "tem_mais": False}
    por_imagem = classificacao_crud.obter_classificacoes_imagens(db, id_con, imagens)
    from ics_tpu_torch.crud.modelo_crud import sugestoes_por_imagens

    sugestoes = sugestoes_por_imagens(
        db, [img.content_hash for img in imagens], id_amb=id_amb
    )
    out = []
    for img in imagens:
        out.append(
            {
                "content_hash": img.content_hash,
                "nome_img": img.nome_img,
                "caminho_img": img.caminho_img,
                "data_proc": img.data_proc,
                "data_sinc": img.data_sinc,
                "download_url": _download_url(img.caminho_img),
                "classificacoes": [
                    _classificacao_info(db, c)
                    for c in por_imagem.get(img.content_hash, [])
                ],
                # model suggestion (classify-on-sync / classificar-tpu);
                # null until a model has seen the image
                "sugestao_modelo": sugestoes.get(img.content_hash),
            }
        )
    return {"imagens": out, "total": len(out), "tem_mais": tem_mais}


@router.get("/ambiente/{id_amb}/inicializar")
async def inicializar_classificacao(request: Request):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    imagens, tem_mais = classificacao_crud.buscar_imagens_inicial(
        db, id_amb, id_con, limit=PAGE
    )
    return JSONResponse(
        _montar_resposta_imagens(db, imagens, id_con, tem_mais, id_amb=id_amb)
    )


@router.get("/ambiente/{id_amb}/priorizadas")
async def imagens_priorizadas(request: Request):
    """Active-learning page (net-new, no reference counterpart): the
    user's unclassified images of the ambiente ranked by the trained
    model's uncertainty, most uncertain first — labeling these teaches the
    next fine-tune the most per human click.

    Uncertainty is margin-based for softmax models and decision-boundary
    proximity for ``multipla_escolha`` (sigmoid) models, persisted on each
    suggestion row (``sugestoes_modelo.incerteza``) by classify-on-sync /
    ``classificar-tpu``, so the ranking is a single indexed SQL query.
    Empty until a trained model has scored the ambiente's images."""
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    try:
        limite = int(request.query_params.get("limite", PAGE))
    except (TypeError, ValueError):
        raise HTTPException(422, "limite deve ser um inteiro.")
    limite = max(1, min(limite, 100))
    from ics_tpu_torch.crud.modelo_crud import imagens_priorizadas as _priorizadas

    ranked = _priorizadas(db, id_amb, id_con, limit=limite)
    resposta = _montar_resposta_imagens(
        db, [img for img, _ in ranked], id_con, tem_mais=False, id_amb=id_amb
    )
    for item, (_, incerteza) in zip(resposta["imagens"], ranked):
        item["incerteza"] = incerteza
    resposta["ordenado_por"] = "incerteza"
    return JSONResponse(resposta)


@router.get("/ambiente/{id_amb}/sugerir-vizinhos/{content_hash}")
async def sugerir_por_vizinhos(request: Request):
    """kNN suggestion (net-new): label vote over the image's nearest
    LABELED neighbours in embedding space — suggestions on day one, before
    any fine-tune exists for the ambiente. Requires the image to be
    indexed (``POST /inferencia/indexar``); the vote is persisted as a
    regular suggestion (``modelo="knn:<backbone>"``), so it surfaces in
    the paging payload and ranks the priorizadas page.

    ``?k=`` neighbours in the vote (1-50, default 10)."""
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    content_hash = request.path_params["content_hash"]
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    service = request.app.state.get("engine")
    if service is None:
        raise HTTPException(503, "Serviço de inferência indisponível.")
    try:
        k = int(request.query_params.get("k", 10))
    except (TypeError, ValueError):
        raise HTTPException(422, "k deve ser um inteiro.")
    k = max(1, min(k, 50))
    from ics_tpu_torch.api.routes.images import _embedding_index
    from ics_tpu_torch.crud.modelo_crud import registrar_sugestao
    from ics_tpu_torch.runtime.knn_suggest import (
        existe_imagem_no_ambiente,
        knn_sugerir,
    )

    if not existe_imagem_no_ambiente(db, id_amb, content_hash):
        raise HTTPException(404, "Imagem não encontrada neste ambiente.")
    ambiente = db.get(Ambiente, str(id_amb))
    multi = bool(ambiente is not None and ambiente.multipla_escolha)
    modelo = service.engine.model_name
    index = _embedding_index(request, modelo)
    import asyncio

    # the vote's device top-k + label join run off the event loop
    result = await asyncio.get_running_loop().run_in_executor(
        None,
        lambda: knn_sugerir(
            db, index, id_amb, content_hash, k=k, multi_label=multi
        ),
    )
    if result is None:
        raise HTTPException(
            404,
            "Imagem sem embedding indexado. Use POST /inferencia/indexar.",
        )
    opcoes_out = []
    for o in result["opcoes"]:
        opcao = db.get(Opcao, o["id_opc"])
        opcoes_out.append(
            {
                "id_opc": o["id_opc"],
                "texto_opcao": opcao.texto if opcao else None,
                "score": round(o["score"], 6),
            }
        )
    resposta = {
        "content_hash": content_hash,
        "modelo": f"knn:{modelo}",
        "vizinhos": result["vizinhos"],
        "opcoes": opcoes_out,
    }
    if multi:
        resposta["multi_rotulo"] = True
        resposta["opcoes_sugeridas"] = [
            o for o in opcoes_out if o["score"] >= 0.5
        ]
    if opcoes_out:
        registrar_sugestao(
            db, content_hash,
            modelo=f"knn:{modelo}",
            classes=opcoes_out,
            score=opcoes_out[0]["score"],
            id_amb=id_amb,
            id_opc=opcoes_out[0]["id_opc"],
        )
        db.commit()
    return JSONResponse(resposta)


@router.get("/contagem")
async def obter_contagem_classificacoes(request: Request):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    from ics_tpu_torch.crud.user_crud import get_convencional_by_usuario

    con = get_convencional_by_usuario(db, usuario.id_usu)
    if con is None:
        return JSONResponse({"total": 0})
    return JSONResponse(
        {"total": classificacao_crud.contar_imagens_classificadas(db, con.id_con)}
    )


async def _paginar(request: Request, direction: str):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    body = await request.json()
    content_hash = body.get("content_hash") or ""
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    fn = (
        classificacao_crud.buscar_imagens_avancar
        if direction == "avancar"
        else classificacao_crud.buscar_imagens_voltar
    )
    imagens, tem_mais = fn(db, id_amb, id_con, content_hash, limit=PAGE)
    if not imagens:
        detalhe = (
            "Não há mais imagens disponíveis ou a imagem de referência não foi "
            "encontrada."
            if direction == "avancar"
            else "Não há imagens anteriores ou a imagem de referência não foi "
            "encontrada."
        )
        raise HTTPException(404, detalhe)
    return JSONResponse(
        _montar_resposta_imagens(db, imagens, id_con, tem_mais, id_amb=id_amb)
    )


@router.post("/ambiente/{id_amb}/avancar")
async def avancar_imagens(request: Request):
    return await _paginar(request, "avancar")


@router.post("/ambiente/{id_amb}/voltar")
async def voltar_imagens(request: Request):
    return await _paginar(request, "voltar")


@router.post("/ambiente/{id_amb}/classificar")
async def classificar_imagem(request: Request):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    body = await request.json()
    content_hash = body.get("content_hash") or ""
    id_opc = body.get("id_opc") or []
    if not isinstance(id_opc, list):
        raise HTTPException(422, "id_opc deve ser uma lista de IDs de opções.")
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)

    imagem = db.get(Imagem, content_hash)
    if imagem is not None:
        conjuntos = classificacao_crud.buscar_conjuntos_ambiente(db, id_amb)
        if imagem.id_cnj not in conjuntos:
            raise HTTPException(400, "A imagem não pertence a este ambiente.")

    # single-choice enforcement for multipla_escolha=False ambientes —
    # server-side (the reference left this client-side only, §2.4.7)
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is not None and not ambiente.multipla_escolha and len(id_opc) > 1:
        raise HTTPException(
            422, "Este ambiente permite apenas uma opção por imagem."
        )

    classificacoes, total_novas = (
        classificacao_crud.criar_ou_atualizar_classificacao(
            db, id_con, id_amb, content_hash, id_opc
        )
    )
    if not classificacoes:
        raise HTTPException(
            400,
            "Não foi possível criar/atualizar a classificação. Verifique se a "
            "imagem e as opções são válidas.",
        )
    db.commit()
    progresso = classificacao_crud.obter_progresso_usuario(db, id_con, id_amb)
    mensagem = (
        f"Classificação salva com sucesso. {total_novas} nova(s) opção(ões) "
        "adicionada(s)."
        if total_novas > 0
        else "Classificação atualizada com sucesso."
    )
    return JSONResponse(
        {
            "message": mensagem,
            "classificacoes": [_classificacao_info(db, c) for c in classificacoes],
            "total_classificadas": progresso.total_classificadas if progresso else 0,
        }
    )


@router.get("/imagem/{content_hash}")
async def obter_classificacoes_imagem(request: Request):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    content_hash = request.path_params["content_hash"]
    id_con = _obter_id_con_usuario(db, usuario)
    imagem = db.get(Imagem, content_hash)
    if imagem is None:
        raise HTTPException(404, "Imagem não encontrada.")
    rows = (
        db.query(Classificacao)
        .filter(
            Classificacao.id_con == id_con,
            Classificacao.id_img == content_hash,
            Classificacao.ativo == True,  # noqa: E712
        )
        .all()
    )
    return JSONResponse(
        {
            "content_hash": imagem.content_hash,
            "nome_img": imagem.nome_img,
            "classificacoes": [_classificacao_info(db, c) for c in rows],
        }
    )


@router.get("/historico")
async def listar_historico_usuario(request: Request):
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    from ics_tpu_torch.crud.user_crud import get_convencional_by_usuario

    con = get_convencional_by_usuario(db, usuario.id_usu)
    if con is None:
        return JSONResponse({"total": 0, "items": []})
    page = request.query_int("page", 1, lo=1)
    page_size = request.query_int("page_size", 50, lo=1, hi=100)
    id_amb: Optional[str] = request.query_params.get("id_amb")
    total, rows = classificacao_crud.listar_historico(
        db, con.id_con, id_amb, page, page_size
    )
    grouped: dict[str, dict] = {}
    for r in rows:
        item = grouped.get(r["content_hash"])
        if item is not None:
            if r["opcao_texto"] not in item["opcoes_lista"]:
                item["opcoes_lista"].append(r["opcao_texto"])
                item["ids_opcoes"].append(str(r["id_opc"]))
        else:
            grouped[r["content_hash"]] = {
                "content_hash": r["content_hash"],
                "nome_img": r["nome_img"],
                "url_img": _download_url(r["caminho_img"]),
                "opcoes_lista": [r["opcao_texto"]],
                "ids_opcoes": [str(r["id_opc"])],
                "data_classificacao": r["data_criado"],
                "nome_ambiente": r["titulo_amb"],
                "id_amb": str(r["id_amb"]),
            }
    items = []
    for item in grouped.values():
        item["opcao_escolhida"] = ", ".join(item.pop("opcoes_lista"))
        items.append(item)
    return JSONResponse({"total": total, "items": items})


# --- model inference under the same surface ---------------------------------


async def _servico_arquivo_modelo(request: Request, db, id_amb: str):
    """What the upload routes (classificar-tpu, explicar) share: 503 without
    an engine, 422 without a 'file' part, and the trained version's service
    where the ambiente has an active registered model; 503 naming the
    conversion tool where that version is there only as the JAX trainer's
    orbax checkpoint. Returns ``(service, file, modelo_row)``."""
    service = request.app.state.get("engine")
    pool = request.app.state.get("engine_pool")
    if service is None:
        raise HTTPException(503, "Serviço de inferência indisponível.")
    form = await request.form()
    files = form.getfiles("file") or form.getfiles("files")
    if not files:
        raise HTTPException(422, "Envie a imagem no campo 'file'.")
    from ics_tpu_torch.crud import modelo_crud

    modelo_row = modelo_crud.modelo_ativo(db, id_amb)
    if modelo_row is not None and pool is not None:
        try:
            service = await pool.get_trained(modelo_row)
        except UnconvertedCheckpointError as exc:
            raise HTTPException(
                503, f"A versão {modelo_row.versao} do modelo treinado foi gravada pelo "
                     f"treinador JAX (orbax) e ainda não foi convertida: execute "
                     f"`python {CONVERSION_TOOL} {exc.directory}`.")
    return service, files[0], modelo_row


def _mapear_opcoes(db, modelo_row, result: dict) -> list[dict]:
    """The result's top-k class indices as the trained model's option labels
    (classes past the option set are skipped)."""
    from ics_tpu_torch.crud import modelo_crud

    inv = modelo_crud.inverse_class_map(modelo_row)
    opcoes_out = []
    for cls_idx, score in zip(result["top_classes"], result["scores"]):
        id_opc = inv.get(int(cls_idx))
        if id_opc is None:
            continue
        opcao = db.get(Opcao, id_opc)
        opcoes_out.append({
            "id_opc": id_opc,
            "texto_opcao": opcao.texto if opcao else None,
            "score": score,
        })
    return opcoes_out


@router.post("/ambiente/{id_amb}/classificar-tpu")
async def classificar_imagem_tpu(request: Request):
    """Model-assisted classification of an image of the ambiente: top-k
    classes and scores beside the human workflow.

    With an active trained model, that version serves and class indices map
    to the ambiente's option labels; the suggestion is stored for a synced
    image. Otherwise the default model serves bare class indices.
    ``?tta=true`` averages the probabilities of the image and its flip."""
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    service, file, modelo_row = await _servico_arquivo_modelo(request, db, id_amb)
    from ics_tpu_torch.crud import auditoria_crud, modelo_crud

    tta = str(request.query_params.get("tta", "")).lower() in ("1", "true", "sim")
    try:
        if tta:
            result = await service.classify_bytes_tta(file.data)
        else:
            result = await service.classify_bytes(file.data)
    except (OSError, ValueError):
        # decode failures only; other errors reach the 500 handler
        raise HTTPException(422, "Imagem inválida ou não decodificável.")

    from ics_tpu_torch.core.security import sha256_hex

    content_hash = sha256_hex(file.data)
    opcoes_out = None
    if modelo_row is not None:
        opcoes_out = _mapear_opcoes(db, modelo_row, result)
        result["opcoes"] = opcoes_out
        result["modelo_versao"] = modelo_row.versao
        result["id_mod"] = str(modelo_row.id_mod)
        metricas = modelo_row.metricas or {}
        if metricas.get("multi_rotulo"):
            # independent sigmoid scores: every option at or above the
            # model's calibrated threshold (0.5 when uncalibrated) is suggested
            limiar = float(metricas.get("limiar") or 0.5)
            result["multi_rotulo"] = True
            result["limiar"] = limiar
            result["opcoes_sugeridas"] = [
                o for o in opcoes_out if (o["score"] or 0.0) >= limiar
            ]
        elif metricas.get("temperatura"):
            # the fitted temperature is folded into the head: the scores are
            # calibrated probabilities, and the client sees which T made them
            result["temperatura"] = float(metricas["temperatura"])

    # the suggestion is stored when the upload is a synced image
    if db.get(Imagem, content_hash) is not None:
        if modelo_row is not None and opcoes_out:
            modelo_crud.registrar_sugestao(
                db, content_hash,
                modelo=modelo_row.nome_modelo,
                classes=opcoes_out,
                score=opcoes_out[0]["score"],
                id_amb=id_amb,
                id_mod=modelo_row.id_mod,
                id_opc=opcoes_out[0]["id_opc"],
                versao=modelo_row.versao,
            )
        else:
            modelo_crud.registrar_sugestao(
                db, content_hash,
                modelo=result["model"],
                classes=[
                    {"classe": int(c), "score": s}
                    for c, s in zip(result["top_classes"], result["scores"])
                ],
                score=result["scores"][0] if result["scores"] else None,
            )

    auditoria_crud.registrar_evento(
        db, "inferencia_tpu", usuario.id_usu,
        {
            "id_amb": id_amb,
            "model": result["model"],
            "modelo_versao": modelo_row.versao if modelo_row is not None else None,
            "content_hash": content_hash,
        },
    )
    db.commit()
    return JSONResponse(result)


@router.post("/ambiente/{id_amb}/explicar")
async def explicar_classificacao(request: Request):
    """Why the model suggested what it suggested: the top-k and a 16x16
    input-gradient saliency grid in [0, 1], in the model's view of the image
    (the square-resized crop).

    ``?id_opc=<uuid>`` explains one option of the ambiente's trained model
    instead of the model's own top class; ``?suavizar=N`` (1 to 16) averages
    the gradients of N noisy copies (SmoothGrad). Nothing is stored."""
    db = request.state.db
    usuario = auth_service.get_current_user(request)
    id_amb = request.path_params["id_amb"]
    id_con = _obter_id_con_usuario(db, usuario)
    _require_acesso(db, id_con, id_amb)
    service, file, modelo_row = await _servico_arquivo_modelo(request, db, id_amb)
    class_idx = -1  # the model's own top class
    id_opc_alvo = request.query_params.get("id_opc")
    if id_opc_alvo:
        if modelo_row is None:
            raise HTTPException(
                422,
                "id_opc requer um modelo treinado ativo para o ambiente "
                "(o modelo genérico não conhece as opções).",
            )
        class_map = modelo_row.class_map or {}
        if str(id_opc_alvo) not in class_map:
            raise HTTPException(
                422,
                f"Opção {id_opc_alvo} não faz parte do modelo ativo "
                f"(versão {modelo_row.versao}).",
            )
        class_idx = int(class_map[str(id_opc_alvo)])

    raw_smooth = request.query_params.get("suavizar")
    smooth = 1
    if raw_smooth:
        try:
            smooth = int(raw_smooth)
        except (TypeError, ValueError):
            raise HTTPException(422, "Parâmetro inválido: suavizar")
        if not (1 <= smooth <= 16):
            raise HTTPException(422, "Parâmetro inválido: suavizar deve estar em [1, 16]")

    from ics_tpu_torch.ops import KernelHasNoGradient

    try:
        result = await service.explain_bytes(file.data, class_idx, smooth)
    except KernelHasNoGradient:
        raise HTTPException(
            422,
            f"Explicação indisponível para o modelo {service.engine.model_name}: "
            "os kernels do seu caminho não têm gradiente.",
        )
    except (OSError, ValueError):
        raise HTTPException(422, "Imagem inválida ou não decodificável.")

    if modelo_row is not None:
        result["opcoes"] = _mapear_opcoes(db, modelo_row, result)
        result["modelo_versao"] = modelo_row.versao
        result["id_mod"] = str(modelo_row.id_mod)
        if id_opc_alvo:
            result["id_opc_explicado"] = str(id_opc_alvo)
    return JSONResponse(result)
