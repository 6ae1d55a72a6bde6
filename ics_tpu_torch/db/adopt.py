"""Take over a reference-created database in place.

    python -m ics_tpu_torch.db.adopt [--database-url URL] [--dry-run]

The succession story: the 16 parity tables are deliberately
table/column-identical to the reference's SQLAlchemy models
(reference ``app/db/models.py:10-283``), and the reference tracks its
schema in ``alembic_version`` with head ``e7efd594e4cd``
(``alembic/versions/e7efd594e4cd_add_multipla_escolha.py``). A reference
database at head therefore IS our m0001 schema — adoption is:

1. verify the database really is an un-adopted reference DB (all parity
   tables present, no ics_tpu_torch revisions recorded, tipo_usuarios ids
   compatible with the seeder's constants)
2. close pre-head drift by applying the reference's own migration deltas
   idempotently (``a3f2b1c4d5e6`` sync_status columns, ``b4e5c6d7e8f9``
   imagens index, ``e7efd594e4cd`` multipla_escolha) — a DB stamped at an
   older alembic revision adopts just as cleanly
3. ``stamp`` m0001 (schema equivalence, nothing executed), then run
   m0002+ — the activity-ID watermark, the TPU model registry,
   suggestion uncertainty, embeddings
4. complete the audit-event catalogue (the reference seeded only 17 of
   the event names its routes query — defect SURVEY §2.4.3)

``alembic_version`` is left untouched so the operator can roll back to
the reference (our m0002+ objects are additive; ``downgrade(db, "0001")``
removes them first). Existing bcrypt credentials keep working: login
verifies ``$2a$/$2b$`` hashes and rehashes to scrypt on first success
(``core/bcrypt_compat.py``, ``services/auth_service.py:45-52``); the
adoption report counts how many users ride that path.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.db.introspect import column_names, table_names
from ics_tpu_torch.db.migrate import applied_revisions, stamp, upgrade_head

logger = logging.getLogger(__name__)

REFERENCE_HEAD = "e7efd594e4cd"

# tables the reference's create_all makes (its app/db/models.py); the
# net-new TPU tables (modelos_treinados, sugestoes_modelo,
# embeddings_imagem) are added by m0003/m0005 after the stamp
PARITY_TABLES = (
    "tipo_usuarios",
    "usuarios",
    "usuarios_administradores",
    "cadastros_permitidos",
    "usuarios_convencionais",
    "ambientes",
    "usuarios_ambientes",
    "usuarios_ambientes_progresso",
    "opcoes",
    "ambientes_conjuntos_imagens",
    "conjuntos_imagens",
    "imagens",
    "classificacoes",
    "eventos_auditoria",
    "logs_auditoria",
    "sync_status",
)

# columns our models carry that m0002+ add — not expected pre-adoption
_POST_M0001_COLUMNS = {("sync_status", "last_activity_id")}

# the reference's own migration deltas, re-applied here when the adopted
# DB predates them: {(table, column): (pg_ddl_type, sqlite_ddl_type)}
_REFERENCE_DELTAS = {
    # a3f2b1c4d5e6_add_sync_status_columns.py
    ("sync_status", "webdav_failures"): (
        "INTEGER NOT NULL DEFAULT 0",
        "INTEGER NOT NULL DEFAULT 0",
    ),
    ("sync_status", "server_offline"): (
        "BOOLEAN NOT NULL DEFAULT FALSE",
        "INTEGER NOT NULL DEFAULT 0",
    ),
    ("sync_status", "last_health_check"): (
        "TIMESTAMP WITH TIME ZONE",
        "TEXT",
    ),
    # e7efd594e4cd_add_multipla_escolha.py
    ("ambientes", "multipla_escolha"): (
        "BOOLEAN DEFAULT FALSE",
        "INTEGER DEFAULT 0",
    ),
}

# b4e5c6d7e8f9_add_idx_imagem_id_cnj_existe.py (IF NOT EXISTS: idempotent
# on DBs where the reference already created it)
_REFERENCE_INDEX = (
    "CREATE INDEX IF NOT EXISTS idx_imagem_id_cnj_existe "
    "ON imagens (id_cnj, existe_no_nextcloud)"
)

# seed.py's fixed ids — an adopted DB whose tipo_usuarios disagrees would
# make the idempotent seeder collide on the UNIQUE(nome) constraint and
# mis-type every future cadastro
_EXPECTED_TIPOS = {"convencional": 1, "admin": 2}


class AdoptError(RuntimeError):
    """The database cannot be adopted as-is; message says why."""


def inspect(db: Database) -> dict:
    """Read-only census of the candidate database (the --dry-run payload)."""
    import ics_tpu_torch.db.models as models  # noqa: F401 — populate registry

    from ics_tpu_torch.db.orm import MODEL_REGISTRY

    report: dict = {}
    with db.session() as s:
        tabs = table_names(s)
        report["missing_tables"] = sorted(
            t for t in PARITY_TABLES if t not in tabs
        )
        # don't call applied_revisions blindly: its bookkeeping-table
        # CREATE would write to a DB we may not own yet
        report["ics_revisions"] = (
            sorted(applied_revisions(s)) if "schema_migrations" in tabs else []
        )
        report["alembic_version"] = None
        if "alembic_version" in tabs:
            row = s.fetchone("SELECT version_num FROM alembic_version")
            report["alembic_version"] = row["version_num"] if row else None
        missing_cols: dict[str, list[str]] = {}
        unfixable: list[str] = []
        for t in PARITY_TABLES:
            if t not in tabs:
                continue
            model = MODEL_REGISTRY[t]
            have = column_names(s, t)
            for name in model.__columns__:
                if name in have or (t, name) in _POST_M0001_COLUMNS:
                    continue
                missing_cols.setdefault(t, []).append(name)
                if (t, name) not in _REFERENCE_DELTAS:
                    unfixable.append(f"{t}.{name}")
        report["missing_columns"] = missing_cols
        report["unfixable_columns"] = unfixable
        report["tipos"] = (
            {
                r["nome"]: r["id_tipo"]
                for r in s.fetchall("SELECT id_tipo, nome FROM tipo_usuarios")
            }
            if "tipo_usuarios" in tabs
            else {}
        )
        for table, key in (
            ("usuarios", "usuarios"),
            ("imagens", "imagens"),
            ("classificacoes", "classificacoes"),
            ("eventos_auditoria", "eventos_auditoria"),
        ):
            report[key] = (
                s.fetchone(f"SELECT COUNT(*) AS n FROM {table}")["n"]
                if table in tabs
                else 0
            )
        report["bcrypt_users"] = (
            s.fetchone(
                "SELECT COUNT(*) AS n FROM usuarios WHERE senha_hash LIKE ?",
                ("$2%",),
            )["n"]
            if "usuarios" in tabs
            else 0
        )
    return report


def _check_adoptable(report: dict, resume: bool = False) -> None:
    if report["ics_revisions"] and not resume:
        raise AdoptError(
            "já é um banco ics_tpu_torch (revisões aplicadas: "
            f"{', '.join(report['ics_revisions'])}) — use as migrações, "
            "não a adoção; se uma adoção anterior foi INTERROMPIDA "
            "(stamp gravado mas migrações/eventos pendentes), re-execute "
            "com --resume: todos os passos são idempotentes"
        )
    if report["missing_tables"]:
        raise AdoptError(
            "não parece um banco do sistema de referência — tabelas "
            f"ausentes: {', '.join(report['missing_tables'])}"
        )
    if report["unfixable_columns"]:
        raise AdoptError(
            "divergência de esquema além das migrações conhecidas da "
            f"referência — colunas ausentes: "
            f"{', '.join(report['unfixable_columns'])}; revise manualmente"
        )
    for nome, expected in _EXPECTED_TIPOS.items():
        actual = report["tipos"].get(nome)
        if actual is not None and actual != expected:
            raise AdoptError(
                f"tipo_usuarios: '{nome}' tem id {actual}, esperado "
                f"{expected} — os ids do seeder (db/seed.py) não batem; "
                "corrija os ids antes de adotar"
            )


def adopt(db: Database, dry_run: bool = False, resume: bool = False) -> dict:
    """Adopt ``db`` (see module docstring); returns the adoption report.

    Raises :class:`AdoptError` when the database is not an un-adopted
    reference DB. ``dry_run`` performs only the inspection + checks.

    ``resume`` finishes an INTERRUPTED adoption: ``stamp`` commits its
    bookkeeping before the m0002+ migrations and event seeding run, so a
    failure between those steps leaves ``schema_migrations`` non-empty and
    a plain re-run would refuse the database. Every adoption step is
    idempotent (column adds are guarded by the inspection, the index is
    IF NOT EXISTS, stamp/upgrade skip applied revisions, event seeding
    inserts only missing names), so resuming simply re-walks them.
    """
    report = inspect(db)
    _check_adoptable(report, resume=resume)
    if report["alembic_version"] is None:
        # a create_all-only dev DB (never ran the reference's alembic):
        # schema introspection above already proved equivalence
        logger.warning(
            "alembic_version ausente — banco criado por create_all(); "
            "prosseguindo pela verificação de esquema"
        )
    elif report["alembic_version"] != REFERENCE_HEAD:
        logger.warning(
            "banco na revisão alembic %s (head da referência: %s) — "
            "aplicando os deltas da própria referência",
            report["alembic_version"],
            REFERENCE_HEAD,
        )
    report["dry_run"] = dry_run
    if dry_run:
        return report

    deltas_applied: list[str] = []
    with db.session() as s:
        pg = s.dialect == "postgres"
        for (table, column), (pg_ddl, lite_ddl) in _REFERENCE_DELTAS.items():
            cols = report["missing_columns"].get(table, ())
            if column in cols:
                s.execute(
                    f"ALTER TABLE {table} ADD COLUMN {column} "
                    + (pg_ddl if pg else lite_ddl)
                )
                deltas_applied.append(f"{table}.{column}")
        s.execute(_REFERENCE_INDEX)
        s.commit()
    report["deltas_applied"] = deltas_applied
    report["stamped"] = stamp(db, "0001")
    report["migrations_applied"] = upgrade_head(db)
    from ics_tpu_torch.db.seed import popular_eventos_auditoria

    with db.session() as s:
        report["eventos_criados"] = popular_eventos_auditoria(s)
        s.commit()
    logger.info(
        "adoção concluída: %d usuários (%d com hash bcrypt), %d imagens, "
        "%d classificações; migrações %s",
        report["usuarios"],
        report["bcrypt_users"],
        report["imagens"],
        report["classificacoes"],
        ", ".join(report["migrations_applied"]),
    )
    return report


def main(argv: Optional[list[str]] = None) -> int:
    from ics_tpu_torch.core.config import settings

    parser = argparse.ArgumentParser(
        prog="python -m ics_tpu_torch.db.adopt", description=__doc__.split("\n")[0]
    )
    parser.add_argument(
        "--database-url",
        default=settings.DATABASE_URL,
        help="banco a adotar (padrão: settings.DATABASE_URL)",
    )
    parser.add_argument(
        "--dry-run",
        action="store_true",
        help="só inspeciona e valida; não escreve nada",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="finaliza uma adoção interrompida (todos os passos são "
        "idempotentes; sem esta flag um banco já parcialmente adotado "
        "é recusado)",
    )
    parser.add_argument(
        "--json", action="store_true", help="relatório em JSON (uma linha)"
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    db = Database(args.database_url)
    if not db.wait_until_ready():
        print("banco indisponível", file=sys.stderr)
        return 2
    try:
        report = adopt(db, dry_run=args.dry_run, resume=args.resume)
    except AdoptError as exc:
        print(f"ERRO: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, ensure_ascii=False))
        return 0
    verb = "adotável" if args.dry_run else "adotado"
    print(f"banco {verb}: {args.database_url}")
    print(
        f"  usuários: {report['usuarios']} "
        f"({report['bcrypt_users']} com hash bcrypt — re-hash no 1º login)"
    )
    print(
        f"  imagens: {report['imagens']}  "
        f"classificações: {report['classificacoes']}"
    )
    print(f"  alembic_version: {report['alembic_version'] or '(ausente)'}")
    if not args.dry_run:
        print(f"  deltas da referência aplicados: {report['deltas_applied'] or '—'}")
        print(f"  migrações aplicadas: {report['migrations_applied']}")
        print(f"  eventos de auditoria completados: {report['eventos_criados']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
