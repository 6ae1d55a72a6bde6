"""Image-embedding store for similarity search (net-new TPU tier).

``embeddings_imagem`` holds one L2-normalized backbone feature vector per
(image, model); the similarity endpoints run an on-device cosine top-k
over the corpus matrix.
"""

from ics_tpu_torch.db.orm import create_table_sql

revision = "0005_embeddings"
down_revision = "0004_sugestao_incerteza"


def upgrade(session) -> None:
    from ics_tpu_torch.db.models import EmbeddingImagem

    for stmt in create_table_sql(EmbeddingImagem):
        session.execute(stmt)


def downgrade(session) -> None:
    session.execute("DROP TABLE IF EXISTS embeddings_imagem")
