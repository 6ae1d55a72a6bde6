"""Migration engine (alembic-equivalent, from scratch).

Revisions are python modules in ``ics_tpu_torch/db/migrations/`` named
``m<NNNN>_<slug>.py`` exposing ``revision``, ``down_revision`` and
``upgrade(session)``.  Applied revisions are recorded in
``schema_migrations``.  ``upgrade_head`` applies pending revisions in chain
order (prod startup); ``stamp_head`` records them without running (dev
startup after ``create_all`` — reference parity with
``app/db/run_migrations.py:26-42``).
"""

from __future__ import annotations

import importlib
import logging
import pkgutil
from typing import Optional

from ics_tpu_torch.db.engine import Database

logger = logging.getLogger(__name__)

MIGRATIONS_PACKAGE = "ics_tpu_torch.db.migrations"


def _load_revisions() -> list:
    package = importlib.import_module(MIGRATIONS_PACKAGE)
    modules = []
    for info in pkgutil.iter_modules(package.__path__):
        if info.name.startswith("m"):
            modules.append(
                importlib.import_module(f"{MIGRATIONS_PACKAGE}.{info.name}")
            )
    # order by down_revision chain
    by_parent = {getattr(m, "down_revision", None): m for m in modules}
    ordered = []
    cursor: Optional[str] = None
    while cursor in by_parent:
        mod = by_parent[cursor]
        ordered.append(mod)
        cursor = mod.revision
    if len(ordered) != len(modules):
        raise RuntimeError("broken migration chain")
    return ordered


def _ensure_table(session) -> None:
    session.execute(
        "CREATE TABLE IF NOT EXISTS schema_migrations ("
        "revision TEXT PRIMARY KEY, applied_at TEXT NOT NULL)"
    )


def applied_revisions(session) -> set[str]:
    _ensure_table(session)
    return {r["revision"] for r in session.fetchall("SELECT revision FROM schema_migrations")}


def upgrade_head(db: Database) -> list[str]:
    from ics_tpu_torch.core.timezone import utcnow

    applied: list[str] = []
    with db.session() as s:
        done = applied_revisions(s)
        for mod in _load_revisions():
            if mod.revision in done:
                continue
            logger.info("applying migration %s", mod.revision)
            mod.upgrade(s)
            s.execute(
                "INSERT INTO schema_migrations (revision, applied_at) VALUES (?, ?)",
                (mod.revision, utcnow().isoformat()),
            )
            applied.append(mod.revision)
        s.commit()
    return applied


def downgrade(db: Database, target: str = "-1") -> list[str]:
    """Revert applied revisions until ``target`` is the head.

    ``target`` is a revision id (full, or unambiguous prefix like
    ``"0004"``), ``"base"`` (revert everything), or ``"-1"`` (revert just
    the newest applied revision) — alembic's CLI semantics
    (reference ``alembic downgrade``; every reference revision implements
    ``downgrade()``, e.g.
    ``alembic/versions/a3f2b1c4d5e6_add_sync_status_columns.py:44``).

    Each reverted revision runs its ``downgrade(session)`` and has its
    ``schema_migrations`` row deleted, newest first, one commit at the
    end (all-or-nothing like ``upgrade_head``)."""
    chain = _load_revisions()
    reverted: list[str] = []
    with db.session() as s:
        done = applied_revisions(s)
        applied_chain = [m for m in chain if m.revision in done]
        if not applied_chain:
            return []
        if target == "-1":
            to_revert = applied_chain[-1:]
        elif target == "base":
            to_revert = applied_chain
        else:
            matches = [
                i for i, m in enumerate(applied_chain)
                if m.revision == target or m.revision.startswith(target)
            ]
            if len(matches) != 1:
                raise ValueError(
                    f"target revision {target!r} is "
                    + ("ambiguous" if matches else "not an applied revision")
                )
            to_revert = applied_chain[matches[0] + 1:]
        for mod in reversed(to_revert):
            fn = getattr(mod, "downgrade", None)
            if fn is None:
                raise RuntimeError(
                    f"revision {mod.revision} has no downgrade()"
                )
            logger.info("reverting migration %s", mod.revision)
            fn(s)
            s.execute(
                "DELETE FROM schema_migrations WHERE revision = ?",
                (mod.revision,),
            )
            reverted.append(mod.revision)
        s.commit()
    return reverted


def stamp(db: Database, target: str) -> list[str]:
    """Record revisions up to ``target`` as applied WITHOUT running them —
    ``alembic stamp <rev>`` semantics, for databases whose schema already
    matches (the reference-DB adoption path, ``db/adopt.py``: a reference
    DB at alembic head e7efd594e4cd is m0001 by construction)."""
    from ics_tpu_torch.core.timezone import utcnow

    chain = _load_revisions()
    matches = [
        i for i, m in enumerate(chain)
        if m.revision == target or m.revision.startswith(target)
    ]
    if len(matches) != 1:
        raise ValueError(
            f"target revision {target!r} is "
            + ("ambiguous" if matches else "unknown")
        )
    stamped: list[str] = []
    with db.session() as s:
        done = applied_revisions(s)
        for mod in chain[: matches[0] + 1]:
            if mod.revision in done:
                continue
            s.execute(
                "INSERT INTO schema_migrations (revision, applied_at) VALUES (?, ?)",
                (mod.revision, utcnow().isoformat()),
            )
            stamped.append(mod.revision)
        s.commit()
    return stamped


def stamp_head(db: Database) -> list[str]:
    from ics_tpu_torch.core.timezone import utcnow

    stamped: list[str] = []
    with db.session() as s:
        done = applied_revisions(s)
        for mod in _load_revisions():
            if mod.revision in done:
                continue
            s.execute(
                "INSERT INTO schema_migrations (revision, applied_at) VALUES (?, ?)",
                (mod.revision, utcnow().isoformat()),
            )
            stamped.append(mod.revision)
        s.commit()
    return stamped


def main(argv: Optional[list] = None) -> int:
    """Operator CLI — alembic-command parity:

        python -m ics_tpu_torch.db.migrate upgrade            # -> head
        python -m ics_tpu_torch.db.migrate downgrade -1       # revert newest
        python -m ics_tpu_torch.db.migrate downgrade 0001     # back to m0001
        python -m ics_tpu_torch.db.migrate downgrade base     # revert everything
        python -m ics_tpu_torch.db.migrate stamp 0001         # record, don't run
        python -m ics_tpu_torch.db.migrate current            # applied revisions
    """
    import argparse
    import sys

    from ics_tpu_torch.core.config import settings

    parser = argparse.ArgumentParser(prog="python -m ics_tpu_torch.db.migrate")
    parser.add_argument(
        "command", choices=["upgrade", "downgrade", "stamp", "current"]
    )
    parser.add_argument("target", nargs="?", default=None)
    parser.add_argument("--database-url", default=settings.DATABASE_URL)
    raw = list(sys.argv[1:] if argv is None else argv)
    # argparse would read the "-1" target as an option flag. Rewrite ONLY
    # the token immediately following the command (any other position is
    # genuinely an option), and use a sentinel no revision id can collide
    # with — rewriting every "-1" to a plain word would silently turn a
    # mistyped target of that name into "revert newest" (review r5).
    sentinel = "\x00minus-one"
    for i, tok in enumerate(raw):
        if tok in ("upgrade", "downgrade", "stamp", "current"):
            if i + 1 < len(raw) and raw[i + 1] == "-1":
                raw[i + 1] = sentinel
            break
    args = parser.parse_args(raw)
    if args.target == sentinel:
        args.target = "-1"
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    db = Database(args.database_url)
    if not db.wait_until_ready():
        print("banco indisponível", file=sys.stderr)
        return 2
    try:
        if args.command == "upgrade":
            print(f"aplicadas: {upgrade_head(db) or '(nenhuma pendente)'}")
        elif args.command == "downgrade":
            if args.target is None:
                parser.error("downgrade requer alvo: <revisão>, -1 ou base")
            print(f"revertidas: {downgrade(db, args.target) or '(nenhuma)'}")
        elif args.command == "stamp":
            if args.target is None:
                parser.error("stamp requer alvo: <revisão>")
            print(f"registradas: {stamp(db, args.target) or '(nenhuma)'}")
        else:  # current
            with db.session() as s:
                chain = [m.revision for m in _load_revisions()]
                done = applied_revisions(s)
            for rev in chain:
                print(f"{'x' if rev in done else ' '} {rev}")
    except ValueError as exc:  # unknown/ambiguous target: clean exit,
        print(f"ERRO: {exc}", file=sys.stderr)  # not a traceback
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
