"""Pydantic schemas: NextCloud listing + image hash search
(reference: ``app/schemas/nextcloud_schema.py`` + ``image_schema.py``)."""

from __future__ import annotations

from datetime import datetime
from typing import Optional

from pydantic import BaseModel


class ImageItem(BaseModel):
    name: str
    path: str
    content_type: str
    size: int = 0
    last_modified: Optional[datetime] = None
    file_id: str = ""
    etag: str = ""
    download_url: str


class ImageListResponse(BaseModel):
    images: list[ImageItem]
    page: int
    page_size: int
    total: int
    total_pages: int
    has_next: bool
    has_previous: bool


class ConjuntoImagensOut(BaseModel):
    id_cnj: str
    nome_conj: str
    caminho_conj: str
    file_id: str
    imagens_sincronizadas: bool
    existe_no_nextcloud: bool
    data_proc: datetime
    data_sinc: datetime


class ConjuntoImagensListResponse(BaseModel):
    conjuntos: list[ConjuntoImagensOut]
    total: int


class ImagemOut(BaseModel):
    content_hash: str
    nome_img: str
    caminho_img: str
    existe_no_nextcloud: bool
    data_proc: datetime
    data_sinc: datetime
    metadados: Optional[dict] = None


class ImagemListResponse(BaseModel):
    imagens: list[ImagemOut]
    page: int
    page_size: int
    total: int
    total_pages: int
    has_next: bool
    has_previous: bool
    conjunto_info: Optional[ConjuntoImagensOut] = None


class ImagemEncontrada(BaseModel):
    content_hash: str
    nome_img: str
    caminho_img: str


class ResultadoBuscaImagem(BaseModel):
    hash: str
    encontrada: bool
    imagem: Optional[ImagemEncontrada] = None


class RespostaBuscaImagens(BaseModel):
    total_enviadas: int
    total_encontradas: int
    resultados: list[ResultadoBuscaImagem]
