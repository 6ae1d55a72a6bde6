"""Trained-model registry + model suggestions.

Two net-new tables for the TPU tier (no reference counterpart):
``modelos_treinados`` (versioned fine-tuned weights per ambiente, one
``ativo`` serving version) and ``sugestoes_modelo`` (model label
suggestions written by classify-on-sync and ``classificar-tpu``).
"""

from ics_tpu_torch.db.orm import create_table_sql

revision = "0003_model_registry"
down_revision = "0002_activity_id_watermark"


def upgrade(session) -> None:
    from ics_tpu_torch.db.models import ModeloTreinado, SugestaoModelo

    for model in (ModeloTreinado, SugestaoModelo):
        for stmt in create_table_sql(model):
            session.execute(stmt)


def downgrade(session) -> None:
    # referrer first: sugestoes_modelo FKs modelos_treinados
    session.execute("DROP TABLE IF EXISTS sugestoes_modelo")
    session.execute("DROP TABLE IF EXISTS modelos_treinados")
