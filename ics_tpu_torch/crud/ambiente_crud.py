"""Ambiente CRUD (reference: ``app/crud/ambiente_crud.py``)."""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import IntegrityError, Session
from ics_tpu_torch.db.models import (
    Ambiente,
    AmbienteConjuntoImagens,
    ConjuntoImagens,
    Imagem,
    Opcao,
    Usuario,
    UsuarioAmbiente,
    UsuarioConvencional,
)


def obter_imagens_preview_ambiente(db: Session, id_amb: str, limit: int = 5):
    rows = db.fetchall(
        """
        SELECT i.* FROM imagens i
        JOIN ambientes_conjuntos_imagens aci ON aci.id_cnj = i.id_cnj
        WHERE aci.id_amb = ? AND aci.ativo = 1
          AND i.existe_no_nextcloud = 1
        LIMIT ?
        """,
        [str(id_amb), limit],
    )
    return [Imagem.from_row(r) for r in rows]


def verificar_ambiente_possui_usuarios(db: Session, id_amb: str) -> bool:
    return (
        db.query(UsuarioAmbiente).filter(UsuarioAmbiente.id_amb == str(id_amb)).count()
        > 0
    )


def substituir_opcoes_ambiente(db: Session, id_amb: str, novas_opcoes: list) -> bool:
    """Delete + recreate: Opcao.texto is immutable, so replacement is the
    only edit path (and it is gated on no-specialists by the route)."""
    db.execute("DELETE FROM opcoes WHERE id_amb = ?", [str(id_amb)])
    for texto in novas_opcoes:
        db.add(Opcao(id_amb=str(id_amb), texto=texto))
    db.flush()
    return True


def criar_ambiente(
    db: Session,
    titulo_amb: str,
    titulo_questionario: Optional[str],
    descricao_questionario: str,
    id_adm: str,
    ids_conjuntos: list[str],
    opcoes: list[str],
    multipla_escolha: bool = False,
):
    if not ids_conjuntos or len(opcoes or []) < 2:
        return None, []
    opcoes_validas = [
        t.strip() for t in opcoes if t and t.strip() and len(t.strip()) <= 255
    ]
    if len(set(opcoes_validas)) < 2:
        return None, []
    ids_unicos = list(dict.fromkeys(str(i) for i in ids_conjuntos))
    opcoes_unicas = list(dict.fromkeys(opcoes_validas))

    validos = (
        db.query(ConjuntoImagens).filter(ConjuntoImagens.id_cnj.in_(ids_unicos)).all()
    )
    if {str(c.id_cnj) for c in validos} != set(ids_unicos):
        return None, []

    agora = tz.utcnow()
    novo = Ambiente(
        titulo_amb=titulo_amb,
        titulo_questionario=(titulo_questionario or "").strip() or None,
        descricao_questionario=descricao_questionario,
        multipla_escolha=multipla_escolha,
        data_criado=agora,
        id_adm=str(id_adm),
        ativo=True,
    )
    db.add(novo)
    try:
        db.flush()
        for id_cnj in ids_unicos:
            db.add(
                AmbienteConjuntoImagens(
                    id_amb=novo.id_amb, id_cnj=id_cnj,
                    data_associado=agora, ativo=True,
                )
            )
        for texto in opcoes_unicas:
            db.add(Opcao(texto=texto, id_amb=novo.id_amb))
        db.flush()
        return novo, ids_unicos
    except IntegrityError:
        db.rollback()
        return None, []


def listar_ambientes(db: Session):
    return db.query(Ambiente).all()


def buscar_ambiente_por_titulo(db: Session, titulo_amb: str):
    return db.query(Ambiente).filter(Ambiente.titulo_amb == titulo_amb).first()


def excluir_ambiente(db: Session, id_amb: str):
    ambiente = (
        db.query(Ambiente)
        .filter(Ambiente.id_amb == str(id_amb), Ambiente.ativo == True)  # noqa: E712
        .first()
    )
    if ambiente is None:
        return None
    ambiente.ativo = False
    for assoc in (
        db.query(AmbienteConjuntoImagens)
        .filter(
            AmbienteConjuntoImagens.id_amb == str(id_amb),
            AmbienteConjuntoImagens.ativo == True,  # noqa: E712
        )
        .all()
    ):
        assoc.ativo = False
    for assoc in (
        db.query(UsuarioAmbiente)
        .filter(
            UsuarioAmbiente.id_amb == str(id_amb),
            UsuarioAmbiente.ativo == True,  # noqa: E712
        )
        .all()
    ):
        assoc.ativo = False
    db.flush()
    return ambiente


def reativar_ambiente(db: Session, id_amb: str):
    ambiente = (
        db.query(Ambiente)
        .filter(Ambiente.id_amb == str(id_amb), Ambiente.ativo == False)  # noqa: E712
        .first()
    )
    if ambiente is None:
        return None
    assoc_conjuntos = (
        db.query(AmbienteConjuntoImagens)
        .filter(
            AmbienteConjuntoImagens.id_amb == str(id_amb),
            AmbienteConjuntoImagens.ativo == False,  # noqa: E712
        )
        .all()
    )
    assoc_usuarios = (
        db.query(UsuarioAmbiente)
        .filter(
            UsuarioAmbiente.id_amb == str(id_amb),
            UsuarioAmbiente.ativo == False,  # noqa: E712
        )
        .all()
    )
    if not assoc_conjuntos and not assoc_usuarios:
        return None

    # associations already active BEFORE this call (partial states)
    ja_ativos = (
        db.query(AmbienteConjuntoImagens)
        .filter(
            AmbienteConjuntoImagens.id_amb == str(id_amb),
            AmbienteConjuntoImagens.ativo == True,  # noqa: E712
        )
        .count()
    )
    reativadas = 0
    conjuntos_reativados = 0
    if assoc_conjuntos:
        ids = [a.id_cnj for a in assoc_conjuntos]
        validos = {
            c.id_cnj
            for c in db.query(ConjuntoImagens)
            .filter(
                ConjuntoImagens.id_cnj.in_(ids),
                ConjuntoImagens.existe_no_nextcloud == True,  # noqa: E712
            )
            .all()
        }
        for a in assoc_conjuntos:
            if a.id_cnj in validos:
                a.ativo = True
                reativadas += 1
                conjuntos_reativados += 1
    for a in assoc_usuarios:
        con = db.get(UsuarioConvencional, a.id_con)
        if con is not None:
            user = db.get(Usuario, con.id_usu)
            if user is not None and user.ativo:
                a.ativo = True
                reativadas += 1
    # an ambiente whose conjuntos no longer exist on NextCloud must not
    # go live with ONLY user links reactivated (it would list with zero
    # images and an empty classification page; self-review r3). Counted
    # in memory: the a.ativo mutations above are not flushed yet.
    if reativadas > 0 and (conjuntos_reativados + ja_ativos) > 0:
        ambiente.ativo = True
        db.flush()
        return ambiente
    return None


def obter_conjuntos_do_ambiente(db: Session, id_amb: str) -> list[str]:
    # ativo filter: admin views must agree with the specialist-facing
    # counts (a deactivated association's images counted here but not
    # there — progress percentages never reached 100%; self-review r3)
    rows = (
        db.query(AmbienteConjuntoImagens)
        .filter(
            AmbienteConjuntoImagens.id_amb == str(id_amb),
            AmbienteConjuntoImagens.ativo == True,  # noqa: E712
        )
        .all()
    )
    return [str(a.id_cnj) for a in rows]


def obter_totais_imagens_por_ambiente(db: Session) -> dict[str, int]:
    rows = db.fetchall(
        """
        SELECT aci.id_amb AS id_amb, COUNT(i.content_hash) AS total
        FROM ambientes_conjuntos_imagens aci
        JOIN imagens i ON i.id_cnj = aci.id_cnj
        WHERE aci.ativo = 1 AND i.existe_no_nextcloud = 1
        GROUP BY aci.id_amb
        """
    )
    return {r["id_amb"]: r["total"] for r in rows}


def _buscar_ambiente(db: Session, id_amb: str) -> Optional[Ambiente]:
    # active AND inactive ambientes are editable (reference parity — its
    # update paths don't filter on ativo either)
    return db.get(Ambiente, str(id_amb))


def atualizar_titulo_ambiente(db: Session, id_amb: str, novo_titulo: str):
    titulo = (novo_titulo or "").strip()
    if not titulo or not (3 <= len(titulo) <= 255):
        return None
    ambiente = _buscar_ambiente(db, id_amb)
    if ambiente is None:
        return None
    dup = buscar_ambiente_por_titulo(db, titulo)
    if dup is not None and str(dup.id_amb) != str(ambiente.id_amb):
        return None
    ambiente.titulo_amb = titulo
    db.flush()
    return ambiente


def atualizar_descricao_questionario(db: Session, id_amb: str, descricao: str):
    texto = (descricao or "").strip()
    if len(texto) < 3:
        return None
    ambiente = _buscar_ambiente(db, id_amb)
    if ambiente is None:
        return None
    ambiente.descricao_questionario = texto
    db.flush()
    return ambiente


def atualizar_titulo_questionario(db: Session, id_amb: str, titulo):
    if titulo is not None:
        titulo = titulo.strip()
        if not titulo or len(titulo) > 255:
            return None
    ambiente = _buscar_ambiente(db, id_amb)
    if ambiente is None:
        return None
    ambiente.titulo_questionario = titulo
    db.flush()
    return ambiente
