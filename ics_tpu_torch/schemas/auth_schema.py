"""Pydantic schemas: auth/users/admin surface
(reference: ``app/schemas/auth_schema.py``).

The route handlers build responses directly (the web tier is
serializer-agnostic); these models are the typed contract used by API
consumers and enforced by the contract test suite.
"""

from __future__ import annotations

from datetime import datetime
from typing import Optional

from pydantic import BaseModel, Field


class Token(BaseModel):
    access_token: str
    token_type: str = "bearer"
    user_type: Optional[int] = None


class UsuarioCreate(BaseModel):
    nome_completo: str
    email: str
    cpf: str
    senha: str
    telefone: Optional[str] = None


class UsuarioOut(BaseModel):
    id_usu: str
    nome_completo: str
    email: str
    telefone: Optional[str] = None
    tipo: str
    cpf: Optional[str] = None
    is_admin: bool
    ativo: bool
    id_con: Optional[str] = None


class UsuarioUpdatePerfil(BaseModel):
    nome_completo: Optional[str] = None
    email: Optional[str] = None
    telefone: Optional[str] = None


class UsuarioUpdateSenha(BaseModel):
    senha_atual: str
    nova_senha: str = Field(min_length=8)


class CadastroPermitidoCreate(BaseModel):
    email: str
    id_tipo: int


class CadastroPermitidoOut(BaseModel):
    id_cad: str
    email: str
    id_tipo: Optional[int] = None
    id_adm: str
    nome_administrador: Optional[str] = None
    data_criado: datetime
    usado: bool = False
    data_expiracao: Optional[datetime] = None
    ativo: bool = True


class AmbienteCreate(BaseModel):
    titulo_amb: str
    titulo_questionario: Optional[str] = None
    descricao_questionario: str
    ids_conjuntos: list[str]
    opcoes: list[str]
    multipla_escolha: bool = False


class AmbienteOut(BaseModel):
    id_amb: str
    titulo_amb: str
    titulo_questionario: Optional[str] = None
    descricao_questionario: str
    data_criado: datetime
    id_adm: str
    nome_administrador: Optional[str] = None
    ativo: bool
    ids_conjuntos: list[str] = []
    total_imagens: int = 0
    multipla_escolha: bool = False


class OpcaoCreate(BaseModel):
    texto: str = Field(min_length=1, max_length=255)


class OpcaoOut(BaseModel):
    id_opc: str
    texto: str
    id_amb: str


class OpcoesListResponse(BaseModel):
    id_amb: str
    titulo_amb: str
    opcoes: list[OpcaoOut]
    total: int


class LogAuditoriaOut(BaseModel):
    id_log: str
    id_usu: Optional[str] = None
    nome_usuario: str
    id_evento: int
    nome_evento: str
    data_evento: datetime
    detalhes: dict = {}


class LogAuditoriaPage(BaseModel):
    logs: list[LogAuditoriaOut]
    page: int
    page_size: int
    total: int
    is_last_page: bool


class EventoAuditoriaOut(BaseModel):
    id_evento: int
    nome: str
    descricao: Optional[str] = None


class AmbienteInfoOut(BaseModel):
    id_amb: str
    titulo_amb: str
    descricao_questionario: str
    ativo: bool
    total_imagens: int = 0
    total_classificadas: int = 0
    multipla_escolha: bool = False


class UsuarioAmbientesOut(BaseModel):
    id_con: str
    nome_completo: str
    email: str
    ambientes: list[AmbienteInfoOut]


class UsuarioInfoOut(BaseModel):
    id_con: str
    nome_completo: str
    email: str
    ativo: bool
    data_associado: datetime


class AmbienteUsuariosOut(BaseModel):
    id_amb: str
    titulo_amb: str
    descricao_questionario: str
    ativo: bool
    usuarios: list[UsuarioInfoOut]
    total: int
