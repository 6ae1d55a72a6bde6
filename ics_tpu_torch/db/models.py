"""Domain models — 13 tables, table/column parity with the reference
(``reference/app/db/models.py:10-283``), plus immutability of
``Opcao.texto`` enforced at the mapper layer.

Soft-delete policy: rows are never hard-deleted by the application; the
``ativo`` / ``existe_no_nextcloud`` flags implement logical deletion with
full history preservation.
"""

from __future__ import annotations

from ics_tpu_torch.db.orm import (
    Boolean,
    Char,
    Column,
    DateTime,
    Float,
    Index,
    Integer,
    JSONB,
    Model,
    String,
    Text,
    Uuid,
    new_uuid,
)


class TipoUsuario(Model):
    __tablename__ = "tipo_usuarios"
    id_tipo = Column(Integer, primary_key=True)
    nome = Column(String(50), nullable=False, unique=True)


class Usuario(Model):
    __tablename__ = "usuarios"
    id_usu = Column(Uuid, primary_key=True, default=new_uuid)
    nome_completo = Column(String(255), nullable=False)
    email = Column(String(255), nullable=False, unique=True, index=True)
    telefone = Column(String(20))
    senha_hash = Column(String(128), nullable=False)
    data_criado = Column(DateTime, nullable=False)
    data_ultimo_login = Column(DateTime)
    ativo = Column(Boolean, nullable=False, default=True)
    id_tipo = Column(Integer, foreign_key="tipo_usuarios.id_tipo")


class UsuarioAdministrador(Model):
    __tablename__ = "usuarios_administradores"
    id_adm = Column(Uuid, primary_key=True, default=new_uuid)
    cpf = Column(Char(11), nullable=False, unique=True, index=True)
    id_usu = Column(
        Uuid, foreign_key="usuarios.id_usu", ondelete="CASCADE",
        nullable=False, unique=True,
    )


class CadastroPermitido(Model):
    __tablename__ = "cadastros_permitidos"
    id_cad = Column(Uuid, primary_key=True, default=new_uuid)
    data_criado = Column(DateTime, nullable=False)
    email = Column(String(255), nullable=False, unique=True, index=True)
    usado = Column(Boolean, nullable=False, default=False)
    data_expiracao = Column(DateTime)
    id_tipo = Column(Integer, foreign_key="tipo_usuarios.id_tipo")
    id_adm = Column(
        Uuid, foreign_key="usuarios_administradores.id_adm", ondelete="CASCADE",
        nullable=False,
    )
    ativo = Column(Boolean, nullable=False, default=True)


class UsuarioConvencional(Model):
    __tablename__ = "usuarios_convencionais"
    id_con = Column(Uuid, primary_key=True, default=new_uuid)
    cpf = Column(Char(11), nullable=False, unique=True, index=True)
    id_usu = Column(
        Uuid, foreign_key="usuarios.id_usu", ondelete="CASCADE",
        nullable=False, unique=True,
    )


class Ambiente(Model):
    __tablename__ = "ambientes"
    id_amb = Column(Uuid, primary_key=True, default=new_uuid)
    titulo_amb = Column(String(255), nullable=False, unique=True)
    titulo_questionario = Column(String(255))
    descricao_questionario = Column(Text, nullable=False)
    data_criado = Column(DateTime, nullable=False)
    id_adm = Column(
        Uuid, foreign_key="usuarios_administradores.id_adm", ondelete="CASCADE",
        nullable=False,
    )
    ativo = Column(Boolean, nullable=False, default=True)
    utilizavel = Column(Boolean, nullable=False, default=True)
    multipla_escolha = Column(Boolean, default=False)


class UsuarioAmbiente(Model):
    __tablename__ = "usuarios_ambientes"
    id_con = Column(
        Uuid, foreign_key="usuarios_convencionais.id_con", ondelete="CASCADE",
        primary_key=True,
    )
    id_amb = Column(
        Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE", primary_key=True
    )
    data_associado = Column(DateTime, nullable=False)
    ativo = Column(Boolean, nullable=False, default=True)


class UsuarioAmbienteProgresso(Model):
    """Per-user classification resume cursor (checkpoint/resume semantics,
    SURVEY.md §5)."""

    __tablename__ = "usuarios_ambientes_progresso"
    id_con = Column(
        Uuid, foreign_key="usuarios_convencionais.id_con", ondelete="CASCADE",
        primary_key=True,
    )
    id_amb = Column(
        Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE", primary_key=True
    )
    ultimo_data_proc_processado = Column(DateTime)
    ultimo_content_hash_processado = Column(
        String(64), foreign_key="imagens.content_hash", ondelete="SET NULL"
    )
    total_classificadas = Column(Integer, nullable=False, default=0)
    data_ultima_atividade = Column(DateTime, nullable=False)


class Opcao(Model):
    """Classification option. ``texto`` is IMMUTABLE after creation — the
    annotation history references options by id, so rewriting the text would
    silently rewrite history (reference: ``models.py:105-168``)."""

    __tablename__ = "opcoes"
    id_opc = Column(Uuid, primary_key=True, default=new_uuid)
    texto = Column(String(255), nullable=False)
    id_amb = Column(
        Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE", nullable=False
    )

    def __setattr__(self, key, value):
        if (
            key == "texto"
            and self.__dict__.get("texto") is not None
            and self.__dict__.get("id_opc") is not None
        ):
            raise ValueError(
                "O campo 'texto' de uma Opção é IMUTÁVEL após a criação. "
                "Para modificar uma opção, crie uma nova opção."
            )
        super().__setattr__(key, value)


class AmbienteConjuntoImagens(Model):
    __tablename__ = "ambientes_conjuntos_imagens"
    id_amb = Column(
        Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE", primary_key=True
    )
    id_cnj = Column(
        Uuid, foreign_key="conjuntos_imagens.id_cnj", ondelete="CASCADE",
        primary_key=True,
    )
    data_associado = Column(DateTime, nullable=False)
    ativo = Column(Boolean, nullable=False, default=True)


class ConjuntoImagens(Model):
    """A NextCloud folder, keyed by its persistent ``file_id``."""

    __tablename__ = "conjuntos_imagens"
    id_cnj = Column(Uuid, primary_key=True, default=new_uuid)
    nome_conj = Column(String(255), nullable=False)
    caminho_conj = Column(String(255), nullable=False)
    file_id = Column(String(255), nullable=False, unique=True)
    imagens_sincronizadas = Column(Boolean, nullable=False, default=False)
    existe_no_nextcloud = Column(Boolean, nullable=False, default=True)
    data_proc = Column(DateTime, nullable=False)
    data_sinc = Column(DateTime, nullable=False)


class Imagem(Model):
    """An image, keyed by the SHA-256 of its bytes (content identity)."""

    __tablename__ = "imagens"
    __table_args__ = (
        Index("idx_imagem_id_cnj_existe", "id_cnj", "existe_no_nextcloud"),
    )
    content_hash = Column(String(64), primary_key=True)
    nome_img = Column(String(255), nullable=False)
    caminho_img = Column(String(255), nullable=False)
    metadados = Column(JSONB)
    existe_no_nextcloud = Column(Boolean, nullable=False, default=True)
    data_proc = Column(DateTime, nullable=False)
    data_sinc = Column(DateTime, nullable=False)
    id_cnj = Column(
        Uuid, foreign_key="conjuntos_imagens.id_cnj", ondelete="CASCADE",
        nullable=False,
    )


class Classificacao(Model):
    __tablename__ = "classificacoes"
    __table_args__ = (
        Index("idx_classificacao_usuario_imagem_ativo", "id_con", "id_img", "ativo"),
        Index("idx_classificacao_usuario_imagem_opcao", "id_con", "id_img", "id_opc"),
    )
    id_cla = Column(Uuid, primary_key=True, default=new_uuid)
    data_criado = Column(DateTime, nullable=False)
    data_modificado = Column(DateTime)
    id_con = Column(
        Uuid, foreign_key="usuarios_convencionais.id_con", ondelete="CASCADE",
        nullable=False, index=True,
    )
    id_img = Column(
        String(64), foreign_key="imagens.content_hash", ondelete="CASCADE",
        nullable=False, index=True,
    )
    id_opc = Column(
        Uuid, foreign_key="opcoes.id_opc", ondelete="RESTRICT",
        nullable=False, index=True,
    )
    ativo = Column(Boolean, nullable=False, default=True)


class EventoAuditoria(Model):
    __tablename__ = "eventos_auditoria"
    id_evento = Column(Integer, primary_key=True)
    nome = Column(String(100), nullable=False, unique=True)
    descricao = Column(String(255))


class LogAuditoria(Model):
    __tablename__ = "logs_auditoria"
    id_log = Column(Uuid, primary_key=True, default=new_uuid)
    id_usu = Column(Uuid, foreign_key="usuarios.id_usu")
    evento_id = Column(
        Integer, foreign_key="eventos_auditoria.id_evento", nullable=False
    )
    data_evento = Column(DateTime, nullable=False, index=True)
    detalhes = Column(JSONB)


class ModeloTreinado(Model):
    """Model-version registry (net-new TPU tier, no reference counterpart).

    One row per fine-tune run on an ambiente's specialist labels; the
    ``ativo`` row of an ambiente is the version its ``classificar-tpu``
    serving uses (BASELINE.json fidelity clause: serving runs versioned,
    trained weights — VERDICT r1 item 2).
    """

    __tablename__ = "modelos_treinados"
    id_mod = Column(Uuid, primary_key=True, default=new_uuid)
    id_amb = Column(
        Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE",
        nullable=False, index=True,
    )
    nome_modelo = Column(String(64), nullable=False)  # registry name
    versao = Column(Integer, nullable=False)          # per-ambiente counter
    num_classes = Column(Integer, nullable=False)
    class_map = Column(JSONB, nullable=False)         # id_opc -> class index
    dir_checkpoint = Column(String(512), nullable=False)
    passo = Column(Integer, nullable=False, default=0)
    metricas = Column(JSONB)                          # loss/accuracy history
    ativo = Column(Boolean, nullable=False, default=False)
    data_criado = Column(DateTime, nullable=False)


class SugestaoModelo(Model):
    """A model's label suggestion for an image.

    Written by classify-on-sync (ingestion front) and by ``classificar-tpu``;
    surfaced alongside human classifications in the paging payload. Rows
    with ``id_amb`` reference a trained per-ambiente model (``id_opc`` is
    the suggested option); generic-model rows have both as NULL and carry
    raw class indices in ``classes``.
    """

    __tablename__ = "sugestoes_modelo"
    __table_args__ = (
        Index("idx_sugestao_img_amb", "id_img", "id_amb"),
        # active-learning ranking: priorizadas pages ORDER BY incerteza DESC
        Index("idx_sugestao_amb_incerteza", "id_amb", "incerteza"),
    )
    id_sug = Column(Uuid, primary_key=True, default=new_uuid)
    id_img = Column(
        String(64), foreign_key="imagens.content_hash", ondelete="CASCADE",
        nullable=False, index=True,
    )
    id_amb = Column(Uuid, foreign_key="ambientes.id_amb", ondelete="CASCADE")
    id_mod = Column(Uuid, foreign_key="modelos_treinados.id_mod")
    id_opc = Column(Uuid, foreign_key="opcoes.id_opc", ondelete="CASCADE")
    modelo = Column(String(64), nullable=False)
    versao = Column(Integer)
    score = Column(Float)                             # top-1 probability
    classes = Column(JSONB)                           # top-k details
    # model uncertainty in [0, 1] (margin-based single-label; decision-
    # boundary proximity multi-label) — the active-learning ranking key
    incerteza = Column(Float)
    data_criado = Column(DateTime, nullable=False)


class EmbeddingImagem(Model):
    """L2-normalized backbone embedding of an image (net-new TPU tier).

    Written by the indexing route / embed-on-sync hook; powers the
    similarity-search endpoints (``/images/buscar-similares``) via an
    on-device cosine top-k over the corpus matrix. The vector is stored
    as base64 of little-endian float16 (the ORM stores rich values as
    TEXT by design — portable across both dialects)."""

    __tablename__ = "embeddings_imagem"
    id_img = Column(
        String(64), foreign_key="imagens.content_hash", ondelete="CASCADE",
        primary_key=True,
    )
    modelo = Column(String(64), primary_key=True)
    dim = Column(Integer, nullable=False)
    vetor = Column(Text, nullable=False)
    data_criado = Column(DateTime, nullable=False)


class SyncStatus(Model):
    """Singleton row (id=1) holding sync watermarks + circuit-breaker state."""

    __tablename__ = "sync_status"
    id = Column(Integer, primary_key=True, default=1)
    last_activity_api_sync = Column(DateTime)
    # Activity API watermark: ``since`` is the last-seen ACTIVITY ID (the
    # reference wrongly passed unix timestamps — defect fixed)
    last_activity_id = Column(Integer)
    last_webdav_sync = Column(DateTime)
    webdav_initial_sync_start = Column(DateTime)
    activity_api_available = Column(Boolean, nullable=False, default=True)
    activity_api_last_check = Column(DateTime)
    activity_api_failures = Column(Integer, nullable=False, default=0)
    webdav_failures = Column(Integer, nullable=False, default=0)
    server_offline = Column(Boolean, nullable=False, default=False)
    last_health_check = Column(DateTime)
    sync_in_progress = Column(Boolean, nullable=False, default=False)
    last_sync_status = Column(String(50))
    last_sync_error = Column(Text)
    last_sync_method = Column(String(50))
    created_at = Column(DateTime, nullable=False)
    updated_at = Column(DateTime, nullable=False)


# Audit event catalogue: the union of the names the reference seeded
# (``database.py:74-92``) and the names its routes actually query — the
# reference only seeded 17, so several audited routes silently skipped
# logging (defect SURVEY.md §2.4.3); here the catalogue is complete.
AUDIT_EVENTS: list[tuple[str, str]] = [
    # seeded by the reference
    ("login", "Login de usuário"),
    ("cadastrar_usuario_convencional", "Cadastro de usuário convencional"),
    ("cadastrar_usuario_administrador", "Cadastro de usuário administrador"),
    ("listar_usuarios", "Listagem de usuários"),
    ("excluir_usuario", "Exclusão lógica de usuário"),
    ("reativar_usuario", "Reativação de usuário"),
    ("cadastrar_email_permitido", "Cadastro de e-mail permitido"),
    ("listar_cadastros_permitidos", "Listagem de e-mails permitidos"),
    ("excluir_cadastro_permitido", "Exclusão lógica de e-mail permitido"),
    ("reativar_cadastro_permitido", "Reativação de e-mail permitido"),
    ("criar_ambiente", "Criação de ambiente"),
    ("excluir_ambiente", "Exclusão lógica de ambiente"),
    ("reativar_ambiente", "Reativação de ambiente"),
    ("associar_todos_usuarios_ambiente",
     "Associação de todos os usuários convencionais a um ambiente"),
    ("associar_usuario_ambiente", "Associação de usuário a um ambiente"),
    ("excluir_vinculo_usuario_ambiente",
     "Exclusão lógica de vínculo usuário-ambiente"),
    ("reativar_vinculo_usuario_ambiente",
     "Reativação de vínculo usuário-ambiente"),
    # queried by reference routes but never seeded there (defect fixed)
    ("logout", "Logout de usuário"),
    ("criar_opcao", "Criação de opção"),
    ("atualizar_opcoes_ambiente", "Substituição das opções de um ambiente"),
    ("atualizar_titulo_ambiente", "Atualização do título do ambiente"),
    ("atualizar_descricao_questionario",
     "Atualização da descrição do questionário"),
    ("atualizar_titulo_questionario", "Atualização do título do questionário"),
    ("associar_usuarios_ambiente", "Associação de usuários a um ambiente"),
    ("excluir_associacao_usuario_ambiente",
     "Exclusão lógica de associação usuário-ambiente"),
    ("reativar_associacao_usuario_ambiente",
     "Reativação de associação usuário-ambiente"),
    # net-new (TPU inference tier)
    ("inferencia_tpu", "Inferência TPU executada"),
    ("iniciar_treinamento", "Treinamento de modelo iniciado"),
    ("cancelar_treinamento", "Treinamento de modelo cancelado"),
    ("gc_treinamento", "Limpeza de checkpoints de treinamento"),
    ("ativar_modelo_treinado", "Promoção de modelo treinado para serving"),
    ("importar_modelo_treinado", "Importação de modelo treinado"),
    ("indexar_embeddings", "Indexação de embeddings de similaridade"),
    ("sugestoes_em_lote", "Sugestões de modelo geradas em lote"),
    ("reavaliar_modelo_treinado",
     "Reavaliação de modelo treinado nos rótulos atuais"),
]
