"""Initial schema: all 13 tables + indexes from ics_tpu_torch.db.models."""

from ics_tpu_torch.db.orm import create_table_sql, models_in_fk_order

revision = "0001_initial_schema"
down_revision = None


def upgrade(session) -> None:
    import ics_tpu_torch.db.models  # noqa: F401 — ensure registry is populated

    for model in models_in_fk_order():
        for stmt in create_table_sql(model):
            session.execute(stmt)


def downgrade(session) -> None:
    """Drop every model table (reverse FK order so referrers go first) —
    the base revision's inverse, like the reference's alembic downgrades
    (``alembic/versions/*.py`` all implement ``downgrade()``)."""
    import ics_tpu_torch.db.models  # noqa: F401

    for model in reversed(models_in_fk_order()):
        session.execute(f"DROP TABLE IF EXISTS {model.__tablename__}")
