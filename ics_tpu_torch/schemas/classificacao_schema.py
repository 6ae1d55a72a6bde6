"""Pydantic schemas: classification surface
(reference: ``app/schemas/classificacao_schema.py``)."""

from __future__ import annotations

from datetime import datetime
from typing import Optional

from pydantic import BaseModel


class ClassificacaoInfoOut(BaseModel):
    id_cla: str
    id_opc: str
    texto_opcao: str
    data_criado: datetime
    data_modificado: Optional[datetime] = None


class ImagemClassificacaoOut(BaseModel):
    content_hash: str
    nome_img: str
    caminho_img: str
    data_proc: datetime
    data_sinc: datetime
    download_url: str
    classificacoes: list[ClassificacaoInfoOut] = []


class ImagensClassificacaoResponse(BaseModel):
    imagens: list[ImagemClassificacaoOut]
    total: int
    tem_mais: bool


class AvancarRequest(BaseModel):
    content_hash: str


class VoltarRequest(BaseModel):
    content_hash: str


class ClassificarRequest(BaseModel):
    content_hash: str
    id_opc: list[str]


class ClassificarResponse(BaseModel):
    message: str
    classificacoes: list[ClassificacaoInfoOut]
    total_classificadas: int


class ClassificacoesImagemResponse(BaseModel):
    content_hash: str
    nome_img: str
    classificacoes: list[ClassificacaoInfoOut]


class HistoricoItemOut(BaseModel):
    content_hash: str
    nome_img: str
    url_img: str
    opcao_escolhida: str
    ids_opcoes: list[str]
    data_classificacao: datetime
    nome_ambiente: str
    id_amb: str


class HistoricoResponse(BaseModel):
    total: int
    items: list[HistoricoItemOut]


class OpcaoScoreOut(BaseModel):
    id_opc: str
    texto_opcao: Optional[str] = None
    score: float


class InferenciaTPUOut(BaseModel):
    top_classes: list[int]
    scores: list[float]
    latency_ms: float
    model: str
    # present when the ambiente serves a trained registry version
    opcoes: Optional[list[OpcaoScoreOut]] = None
    modelo_versao: Optional[int] = None
    id_mod: Optional[str] = None
    # multipla_escolha models: independent sigmoid scores; every option
    # at or above the calibrated threshold (limiar) is a suggested label
    multi_rotulo: Optional[bool] = None
    limiar: Optional[float] = None
    opcoes_sugeridas: Optional[list[OpcaoScoreOut]] = None
