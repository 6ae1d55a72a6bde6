"""User-ambiente association CRUD
(reference: ``app/crud/usuarios_ambientes_crud.py``)."""

from __future__ import annotations

from typing import Optional

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.db.engine import IntegrityError, Session
from ics_tpu_torch.db.models import (
    Ambiente,
    AmbienteConjuntoImagens,
    Imagem,
    Usuario,
    UsuarioAmbiente,
    UsuarioAmbienteProgresso,
    UsuarioConvencional,
)


def listar_ambientes_usuario(db: Session, id_con: str):
    con = db.get(UsuarioConvencional, str(id_con))
    if con is None:
        return None, []
    user = db.get(Usuario, con.id_usu)
    if user is None or not user.ativo:
        return None, []

    # ONE joined aggregate instead of 3+ queries per vinculo: a
    # specialist linked to 50 ambientes was ~150 sequential queries per
    # page load on the 1-core host (self-review r3)
    rows = db.fetchall(
        """
        SELECT a.id_amb, a.titulo_amb, a.descricao_questionario,
               a.multipla_escolha,
               COALESCE(img.total, 0) AS total_imagens,
               COALESCE(p.total_classificadas, 0) AS total_classificadas
        FROM usuarios_ambientes ua
        JOIN ambientes a ON a.id_amb = ua.id_amb AND a.ativo = 1
        LEFT JOIN (
            SELECT aci.id_amb AS id_amb, COUNT(i.content_hash) AS total
            FROM ambientes_conjuntos_imagens aci
            JOIN imagens i ON i.id_cnj = aci.id_cnj
            WHERE aci.ativo = 1 AND i.existe_no_nextcloud = 1
            GROUP BY aci.id_amb
        ) img ON img.id_amb = a.id_amb
        LEFT JOIN usuarios_ambientes_progresso p
          ON p.id_amb = a.id_amb AND p.id_con = ua.id_con
        WHERE ua.id_con = ? AND ua.ativo = 1
        """,
        [str(id_con)],
    )
    ambientes = [
        {
            "id_amb": str(r["id_amb"]),
            "titulo_amb": r["titulo_amb"],
            "descricao_questionario": r["descricao_questionario"],
            "ativo": True,
            "total_imagens": int(r["total_imagens"]),
            "total_classificadas": int(r["total_classificadas"]),
            "multipla_escolha": bool(r["multipla_escolha"]),
        }
        for r in rows
    ]
    return con, ambientes


def criar_associacoes(db: Session, id_amb: str, ids_usuarios: list[str]):
    if not ids_usuarios:
        return None, []
    ids_unicos = list(dict.fromkeys(str(i) for i in ids_usuarios))
    ambiente = (
        db.query(Ambiente)
        .filter(Ambiente.id_amb == str(id_amb), Ambiente.ativo == True)  # noqa: E712
        .first()
    )
    if ambiente is None:
        return None, []

    validos = set()
    for id_con in ids_unicos:
        con = db.get(UsuarioConvencional, id_con)
        if con is None:
            continue
        user = db.get(Usuario, con.id_usu)
        if user is not None and user.ativo:
            validos.add(id_con)
    if validos != set(ids_unicos):
        return None, []

    associados = []
    agora = tz.utcnow()
    for id_con in ids_unicos:
        vinculo = db.get(UsuarioAmbiente, id_con, str(id_amb))
        if vinculo is not None:
            if not vinculo.ativo:
                vinculo.ativo = True
                vinculo.data_associado = agora
                associados.append(id_con)
        else:
            db.add(
                UsuarioAmbiente(
                    id_amb=str(id_amb), id_con=id_con,
                    data_associado=agora, ativo=True,
                )
            )
            associados.append(id_con)
    try:
        db.flush()
        return ambiente, associados
    except IntegrityError:
        db.rollback()
        return None, []


def associar_todos_usuarios_ao_ambiente(db: Session, id_amb: str) -> Optional[int]:
    ambiente = (
        db.query(Ambiente)
        .filter(Ambiente.id_amb == str(id_amb), Ambiente.ativo == True)  # noqa: E712
        .first()
    )
    if ambiente is None:
        return None
    rows = db.fetchall(
        """
        SELECT c.id_con FROM usuarios_convencionais c
        JOIN usuarios u ON u.id_usu = c.id_usu
        WHERE u.ativo = 1
        """
    )
    count = 0
    agora = tz.utcnow()
    for r in rows:
        vinculo = db.get(UsuarioAmbiente, r["id_con"], str(id_amb))
        if vinculo is not None:
            if not vinculo.ativo:
                vinculo.ativo = True
                vinculo.data_associado = agora
                count += 1
        else:
            db.add(
                UsuarioAmbiente(
                    id_con=r["id_con"], id_amb=str(id_amb),
                    data_associado=agora, ativo=True,
                )
            )
            count += 1
    db.flush()
    return count


def excluir_associacao(db: Session, id_con: str, id_amb: str):
    vinculo = db.get(UsuarioAmbiente, str(id_con), str(id_amb))
    if vinculo is None or not vinculo.ativo:
        return None
    vinculo.ativo = False
    db.flush()
    return vinculo


def reativar_associacao(db: Session, id_con: str, id_amb: str):
    vinculo = db.get(UsuarioAmbiente, str(id_con), str(id_amb))
    if vinculo is None or vinculo.ativo:
        return None
    ambiente = (
        db.query(Ambiente)
        .filter(Ambiente.id_amb == str(id_amb), Ambiente.ativo == True)  # noqa: E712
        .first()
    )
    if ambiente is None:
        return None
    con = db.get(UsuarioConvencional, str(id_con))
    if con is None:
        return None
    user = db.get(Usuario, con.id_usu)
    if user is None or not user.ativo:
        return None
    vinculo.ativo = True
    db.flush()
    return vinculo


def listar_usuarios_do_ambiente(db: Session, id_amb: str):
    ambiente = db.get(Ambiente, str(id_amb))
    if ambiente is None:
        return None, []
    rows = db.fetchall(
        """
        SELECT c.id_con, u.nome_completo, u.email, u.ativo, ua.data_associado
        FROM usuarios_ambientes ua
        JOIN usuarios_convencionais c ON c.id_con = ua.id_con
        JOIN usuarios u ON u.id_usu = c.id_usu
        WHERE ua.id_amb = ? AND ua.ativo = 1
        """,
        [str(id_amb)],
    )
    from ics_tpu_torch.db.orm import DateTime as _DT

    usuarios = [
        {
            "id_con": r["id_con"],
            "nome_completo": r["nome_completo"],
            "email": r["email"],
            "ativo": bool(r["ativo"]),
            "data_associado": _DT().decode(r["data_associado"]),
        }
        for r in rows
    ]
    return ambiente, usuarios
