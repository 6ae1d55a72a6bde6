"""Schema introspection over both dialects.

sqlite answers via PRAGMA; postgres via ``pg_tables`` /
``information_schema.columns`` (the same views the engine's bootstrap
uses, ``db/engine.py:204``). Shared by the migration guards
(m0002/m0004's add-column-if-missing) and the reference-DB adoption tool
(``db/adopt.py``), so every schema probe goes through one code path.
"""

from __future__ import annotations


def table_names(session) -> set[str]:
    if getattr(session, "dialect", "sqlite") == "postgres":
        return {
            r["name"]
            for r in session.fetchall(
                "SELECT tablename AS name FROM pg_tables "
                "WHERE schemaname = 'public'"
            )
        }
    return {
        r["name"]
        for r in session.fetchall(
            "SELECT name FROM sqlite_master WHERE type='table'"
        )
    }


def column_names(session, table: str) -> set[str]:
    if not table.replace("_", "").isalnum():  # identifier, not injectable
        raise ValueError(f"invalid table name: {table!r}")
    if getattr(session, "dialect", "sqlite") == "postgres":
        return {
            r["column_name"]
            for r in session.fetchall(
                "SELECT column_name FROM information_schema.columns "
                f"WHERE table_name = '{table}'"
            )
        }
    return {r["name"] for r in session.fetchall(f"PRAGMA table_info({table})")}
