"""Ambiente routes (reference: ``app/api/routes/ambientes.py``)."""

from __future__ import annotations

from ics_tpu_torch.crud import ambiente_crud, auditoria_crud, user_crud
from ics_tpu_torch.db.models import Usuario
from ics_tpu_torch.services.auth_service import require_admin
from ics_tpu_torch.web import HTTPException, JSONResponse, Request, Response, Router

router = Router(prefix="/ambientes")


def _ambiente_out(db, ambiente, totais=None) -> dict:
    adm_row = db.fetchone(
        """
        SELECT u.nome_completo FROM usuarios_administradores a
        JOIN usuarios u ON u.id_usu = a.id_usu WHERE a.id_adm = ?
        """,
        [ambiente.id_adm],
    )
    ids_conjuntos = ambiente_crud.obter_conjuntos_do_ambiente(db, ambiente.id_amb)
    if totais is None:
        totais = ambiente_crud.obter_totais_imagens_por_ambiente(db)
    return {
        "id_amb": str(ambiente.id_amb),
        "titulo_amb": ambiente.titulo_amb,
        "titulo_questionario": ambiente.titulo_questionario,
        "descricao_questionario": ambiente.descricao_questionario,
        "data_criado": ambiente.data_criado,
        "id_adm": str(ambiente.id_adm),
        "nome_administrador": adm_row["nome_completo"] if adm_row else "(desconhecido)",
        "ativo": ambiente.ativo,
        "ids_conjuntos": ids_conjuntos,
        "total_imagens": totais.get(str(ambiente.id_amb), 0),
        "multipla_escolha": bool(ambiente.multipla_escolha),
    }


@router.get("/{id_amb}/preview-imagens")
async def preview_imagens_ambiente(request: Request):
    db = request.state.db
    require_admin(request)
    imagens = ambiente_crud.obter_imagens_preview_ambiente(
        db, request.path_params["id_amb"], limit=5
    )
    return JSONResponse(
        {
            "imagens": [
                {
                    "content_hash": i.content_hash,
                    "nome_img": i.nome_img,
                    "caminho_img": i.caminho_img,
                    "classificacao": None,
                }
                for i in imagens
            ]
        }
    )


@router.patch("/{id_amb}/opcoes")
async def atualizar_opcoes_ambiente(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    payload = await request.json()
    opcoes = payload.get("opcoes") or []
    _validar_lista_de_textos(opcoes)
    if len(opcoes) < 2:
        raise HTTPException(400, "O ambiente deve ter pelo menos 2 opções.")
    if ambiente_crud.verificar_ambiente_possui_usuarios(db, id_amb):
        raise HTTPException(
            403,
            "Não é possível editar opções: Este ambiente já possui "
            "especialistas vinculados.",
        )
    ambiente_crud.substituir_opcoes_ambiente(db, id_amb, opcoes)
    auditoria_crud.registrar_evento(
        db, "atualizar_opcoes_ambiente", admin.id_usu,
        {"id_amb": id_amb, "novas_opcoes": opcoes},
    )
    db.commit()
    return JSONResponse({"message": "Opções atualizadas com sucesso!"})


def _validar_lista_de_textos(opcoes) -> None:
    """`opcoes: list[str]` contract (reference app/schemas/auth_schema.py:129
    via pydantic): non-string entries must 422, not crash to 500 downstream
    (found by driving the live route with `[{"texto": ...}]` payloads)."""
    if not isinstance(opcoes, list) or any(
        not isinstance(t, str) for t in opcoes
    ):
        raise HTTPException(
            422, "Opções inválidas: esperada uma lista de textos."
        )


@router.post("/importar")
async def criar_ambiente(request: Request):
    db = request.state.db
    admin = require_admin(request)
    dados = await request.json()
    titulo_amb = dados.get("titulo_amb") or ""
    ids_conjuntos = dados.get("ids_conjuntos") or []
    opcoes = dados.get("opcoes") or []
    _validar_lista_de_textos(opcoes)
    if not titulo_amb.strip() or not dados.get("descricao_questionario"):
        raise HTTPException(422, "Título e descrição do questionário são obrigatórios.")
    if not ids_conjuntos:
        raise HTTPException(
            400,
            "Um ambiente deve estar associado a pelo menos 1 conjunto de imagens.",
        )
    if len(opcoes) < 2:
        raise HTTPException(400, "Um ambiente deve ter pelo menos 2 opções.")
    if ambiente_crud.buscar_ambiente_por_titulo(db, titulo_amb):
        raise HTTPException(409, "Já existe um ambiente com este título.")
    adm = user_crud.get_administrador_by_usuario(db, admin.id_usu)
    novo, ids_validos = ambiente_crud.criar_ambiente(
        db,
        titulo_amb,
        dados.get("titulo_questionario"),
        dados.get("descricao_questionario"),
        adm.id_adm,
        ids_conjuntos,
        opcoes,
        bool(dados.get("multipla_escolha", False)),
    )
    if novo is None:
        raise HTTPException(
            400,
            "Não foi possível criar o ambiente. Verifique se todos os IDs de "
            "conjuntos são válidos, se há pelo menos 2 opções válidas, e se "
            "não há opções duplicadas.",
        )
    auditoria_crud.registrar_evento(
        db, "criar_ambiente", admin.id_usu,
        {
            "id_amb": str(novo.id_amb),
            "titulo_amb": novo.titulo_amb,
            "ids_conjuntos": ids_validos,
        },
    )
    db.commit()
    return JSONResponse(_ambiente_out(db, novo), 201)


@router.get("/")
async def listar_ambientes(request: Request):
    db = request.state.db
    require_admin(request)
    # the image-totals aggregate scans the imagens table; compute it once
    # for the whole listing, not once per ambiente
    totais = ambiente_crud.obter_totais_imagens_por_ambiente(db)
    return JSONResponse(
        [
            _ambiente_out(db, a, totais=totais)
            for a in ambiente_crud.listar_ambientes(db)
        ]
    )


@router.delete("/{id_amb}")
async def excluir_ambiente(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente = ambiente_crud.excluir_ambiente(db, id_amb)
    if ambiente is None:
        raise HTTPException(404, "Ambiente não encontrado ou já inativo.")
    auditoria_crud.registrar_evento(
        db, "excluir_ambiente", admin.id_usu, {"id_amb": id_amb}
    )
    db.commit()
    return Response(b"", 204)


@router.patch("/{id_amb}/reativar")
async def reativar_ambiente(request: Request):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    ambiente = ambiente_crud.reativar_ambiente(db, id_amb)
    if ambiente is None:
        raise HTTPException(
            404,
            "Ambiente não encontrado, já ativo, ou não foi possível reativar "
            "(nenhum conjunto de imagens válido encontrado no NextCloud).",
        )
    auditoria_crud.registrar_evento(
        db, "reativar_ambiente", admin.id_usu, {"id_amb": id_amb}
    )
    db.commit()
    return JSONResponse(
        {
            "message": "Ambiente reativado com sucesso.",
            "ambiente": _ambiente_out(db, ambiente),
        }
    )


async def _patch_field(request: Request, field: str, evento: str, crud_fn, erro: str):
    db = request.state.db
    admin = require_admin(request)
    id_amb = request.path_params["id_amb"]
    payload = await request.json()
    ambiente = crud_fn(db, id_amb, payload.get(field))
    if ambiente is None:
        raise HTTPException(400, erro)
    auditoria_crud.registrar_evento(
        db, evento, admin.id_usu, {"id_amb": id_amb, "novo_valor": payload.get(field)}
    )
    db.commit()
    return JSONResponse(_ambiente_out(db, ambiente))


@router.patch("/{id_amb}/titulo")
async def atualizar_titulo_ambiente(request: Request):
    return await _patch_field(
        request, "titulo_amb", "atualizar_titulo_ambiente",
        ambiente_crud.atualizar_titulo_ambiente,
        "Não foi possível atualizar o título. Verifique se o título é válido "
        "e não está em uso por outro ambiente.",
    )


@router.patch("/{id_amb}/descricao-questionario")
async def atualizar_descricao_questionario(request: Request):
    return await _patch_field(
        request, "descricao_questionario", "atualizar_descricao_questionario",
        ambiente_crud.atualizar_descricao_questionario,
        "Não foi possível atualizar a descrição. Verifique se a descrição é "
        "válida (mínimo 3 caracteres).",
    )


@router.patch("/{id_amb}/titulo-questionario")
async def atualizar_titulo_questionario(request: Request):
    return await _patch_field(
        request, "titulo_questionario", "atualizar_titulo_questionario",
        ambiente_crud.atualizar_titulo_questionario,
        "Não foi possível atualizar o título do questionário. Verifique se o "
        "título é válido (máximo 255 caracteres).",
    )
