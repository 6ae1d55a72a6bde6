"""Model-suggestion uncertainty column (active-learning ranking key).

Adds ``sugestoes_modelo.incerteza`` + its ``(id_amb, incerteza)`` index and
backfills existing rows from their stored score lists so the priorizadas
page ranks the whole corpus, not just post-upgrade suggestions.
"""

import json

revision = "0004_sugestao_incerteza"
down_revision = "0003_model_registry"


def upgrade(session) -> None:
    from ics_tpu_torch.crud.modelo_crud import calcular_incerteza

    from ics_tpu_torch.db.introspect import column_names

    # IF-NOT-EXISTS guard: a fresh upgrade_head run creates the table from
    # the CURRENT model (m0003 create_table_sql), which already carries the
    # column — the same pattern m0002 uses for sync_status
    if "incerteza" not in column_names(session, "sugestoes_modelo"):
        session.execute(
            "ALTER TABLE sugestoes_modelo ADD COLUMN incerteza REAL"
        )
    session.execute(
        "CREATE INDEX IF NOT EXISTS idx_sugestao_amb_incerteza "
        "ON sugestoes_modelo (id_amb, incerteza)"
    )
    # backfill: recompute from the persisted class/score lists with each
    # model's calibration metadata (multi-label threshold)
    meta_cache: dict = {}
    rows = session.fetchall(
        "SELECT id_sug, id_mod, classes FROM sugestoes_modelo"
    )
    for r in rows:
        classes = r["classes"]
        if isinstance(classes, str):
            try:
                classes = json.loads(classes)
            except ValueError:
                classes = None
        multi, limiar = False, 0.5
        if r["id_mod"]:
            key = str(r["id_mod"])
            if key not in meta_cache:
                mod = session.fetchone(
                    "SELECT metricas FROM modelos_treinados WHERE id_mod = ?",
                    (key,),
                )
                meta = (mod or {}).get("metricas")
                if isinstance(meta, str):
                    try:
                        meta = json.loads(meta)
                    except ValueError:
                        meta = None
                meta_cache[key] = meta or {}
            meta = meta_cache[key]
            multi = bool(meta.get("multi_rotulo"))
            limiar = float(meta.get("limiar") or 0.5)
        inc = calcular_incerteza(classes, multi_rotulo=multi, limiar=limiar)
        if inc is not None:
            session.execute(
                "UPDATE sugestoes_modelo SET incerteza = ? WHERE id_sug = ?",
                (inc, r["id_sug"]),
            )


def downgrade(session) -> None:
    """Drop the index then the column; suggestion rows themselves are
    preserved (the reference's index/column downgrades are likewise
    non-destructive to unrelated data,
    ``alembic/versions/b4e5c6d7e8f9_add_idx_imagem_id_cnj_existe.py:28``,
    ``e7efd594e4cd_add_multipla_escolha.py:25``)."""
    session.execute("DROP INDEX IF EXISTS idx_sugestao_amb_incerteza")
    session.execute("ALTER TABLE sugestoes_modelo DROP COLUMN incerteza")
