"""Database engine + unit-of-work session.

Dialects: sqlite3 (stdlib; dev/test) and PostgreSQL (production parity with
the reference's Postgres-15 compose deployment, ``docker-compose.yml:5-21``)
via the built-in wire-protocol client :mod:`ics_tpu_torch.db.pg_wire` — this image
has no psycopg. Reference counterpart: ``app/db/database.py`` (engine,
``SessionLocal``, ``get_db``, ``wait_for_database``).

Session features used by the CRUD layer:
- identity map + dirty tracking (attribute diffs -> UPDATE on flush)
- ``add`` / ``get`` / ``delete`` / ``query(Model)`` chaining
- raw ``execute`` for the explicit-SQL reporting queries
- context-manager transaction semantics (commit/rollback)
"""

from __future__ import annotations

import logging
import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional, Sequence

from ics_tpu_torch.db.orm import (
    MODEL_REGISTRY,
    Expr,
    Model,
    create_table_sql,
    models_in_fk_order,
)

logger = logging.getLogger(__name__)


class IntegrityError(Exception):
    pass


class _PGCursor:
    """Cursor-shaped result holder matching the sqlite3 call sites."""

    def __init__(self, columns: list[str], rows: list[list[Any]]):
        self._rows = [dict(zip(columns, r)) for r in rows]

    def fetchall(self) -> list[dict]:
        return self._rows

    def fetchone(self) -> Optional[dict]:
        return self._rows[0] if self._rows else None


class _PGAdapter:
    """Adapts a PGConnection to the sqlite3.Connection surface Session uses.

    Placeholders translate ``?`` -> ``$N``; a transaction opens lazily on the
    first statement and closes on commit/rollback (postgres autocommits
    otherwise, which would break the unit-of-work contract). ``close()``
    returns a healthy idle connection to the Database's pool — per-request
    sessions must not pay TCP connect + SCRAM PBKDF2 each time."""

    def __init__(self, conn, db: "Database" = None):
        self._conn = conn
        self._db = db

    def execute(self, sql: str, params: Sequence[Any] = ()) -> _PGCursor:
        from ics_tpu_torch.db import pg_wire

        if not self._conn._in_tx:
            self._conn.execute("BEGIN")
        cols, rows, _ = self._conn.execute(
            pg_wire.translate_placeholders(sql), params
        )
        return _PGCursor(cols, rows)

    def commit(self) -> None:
        if self._conn._in_tx:
            _, _, tag = self._conn.execute("COMMIT")
            if tag != "COMMIT":
                # postgres turns COMMIT inside an aborted transaction into
                # ROLLBACK and reports success via the tag — surfacing it
                # as a committed write would be silent data loss (and a
                # divergence from sqlite, which would have committed)
                from ics_tpu_torch.db.pg_wire import PGError

                raise PGError({
                    "C": "25P02",
                    "M": ("COMMIT em transação abortada virou "
                          f"{tag or 'ROLLBACK'} — nada foi gravado"),
                })

    def rollback(self) -> None:
        if self._conn._in_tx:
            self._conn.execute("ROLLBACK")

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self._db is not None and not conn.broken and not conn._in_tx:
            self._db._release_pg(conn)
        else:
            conn.close()


class Database:
    """Connection factory bound to a DSN."""

    def __init__(self, url: str):
        self.url = url
        self._lock = threading.Lock()
        self._memory_conn: Optional[sqlite3.Connection] = None
        if url.startswith("sqlite"):
            self.dialect = "sqlite"
            # sqlite:///:memory: | sqlite:////abs/path.db | sqlite:///rel.db
            path = url.split("///", 1)[-1] if "///" in url else url.split("//")[-1]
            self.path = path or ":memory:"
            self.is_memory = ":memory:" in self.path
            if self.is_memory:
                # shared-CACHE in-memory DB, NOT one shared connection:
                # every Session gets its OWN connection (own transaction
                # scope) to the same data — with a single shared
                # connection, concurrent requests would commit/roll back
                # each other's half-flushed work (self-review r3). The
                # anchor connection below keeps the DB alive.
                self._mem_uri = (
                    f"file:ics_mem_{id(self)}?mode=memory&cache=shared"
                )
                self._memory_conn = self._new_conn(self._mem_uri)
        elif url.startswith(("postgresql", "postgres")):
            self.dialect = "postgres"
            from ics_tpu_torch.db import pg_wire

            self._pg_kwargs = pg_wire.parse_dsn(url)
            self._pg_pool: list = []
            self._pg_pool_max = 8
            self.is_memory = False
        else:
            raise ValueError(f"unsupported DATABASE_URL: {url}")

    def _new_conn(self, path: str) -> sqlite3.Connection:
        conn = sqlite3.connect(
            path, check_same_thread=False, timeout=30.0,
            uri=path.startswith("file:"),
        )
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA foreign_keys = ON")
        if not self.is_memory:
            try:
                conn.execute("PRAGMA journal_mode = WAL")
                conn.execute("PRAGMA synchronous = NORMAL")
            except sqlite3.DatabaseError:
                pass
        return conn

    def connect(self):
        if self.dialect == "postgres":
            from ics_tpu_torch.db.pg_wire import PGConnection

            while True:
                with self._lock:
                    conn = self._pg_pool.pop() if self._pg_pool else None
                if conn is None:
                    conn = PGConnection(**self._pg_kwargs)
                    break
                # liveness ping on pop: a PG restart / idle-timeout / NAT
                # drop kills pooled sockets silently — without this, up
                # to pool-size requests each 500 on a dead connection
                try:
                    conn.execute("SELECT 1")
                    break
                except Exception:
                    try:
                        conn.close()
                    except Exception:
                        pass
            return _PGAdapter(conn, db=self)
        if self.is_memory:
            # per-session connection to the shared-cache in-memory DB:
            # independent transaction scopes over the same data
            return self._new_conn(self._mem_uri)
        return self._new_conn(self.path)

    def _release_pg(self, conn) -> None:
        with self._lock:
            if len(self._pg_pool) < self._pg_pool_max:
                self._pg_pool.append(conn)
                return
        conn.close()

    # -- schema -------------------------------------------------------------
    def create_all(self) -> None:
        with self.session() as s:
            # FK-topological order: PG validates REFERENCES at CREATE time
            for model in models_in_fk_order():
                for stmt in create_table_sql(model):
                    s.execute(stmt)
            s.commit()

    def drop_all(self) -> None:
        with self.session() as s:
            if self.dialect == "postgres":
                rows = s.execute(
                    "SELECT tablename AS name FROM pg_tables "
                    "WHERE schemaname = 'public'"
                ).fetchall()
                for row in rows:
                    s.execute(f'DROP TABLE IF EXISTS "{row["name"]}" CASCADE')
            else:
                rows = s.execute(
                    "SELECT name FROM sqlite_master WHERE type='table' "
                    "AND name NOT LIKE 'sqlite_%'"
                ).fetchall()
                s.execute("PRAGMA foreign_keys = OFF")
                for row in rows:
                    s.execute(f"DROP TABLE IF EXISTS {row['name']}")
                s.execute("PRAGMA foreign_keys = ON")
            s.commit()

    # -- sessions -----------------------------------------------------------
    @contextmanager
    def session(self) -> Iterator["Session"]:
        s = Session(self)
        try:
            yield s
            s.commit()
        except Exception:
            s.rollback()
            raise
        finally:
            s.close()

    def open_session(self) -> "Session":
        return Session(self)

    def wait_until_ready(self, retries: int = 60, delay: float = 0.05) -> bool:
        """Reference parity (``database.py:14-51``): probe until reachable."""
        for attempt in range(retries):
            try:
                with self.session() as s:
                    s.execute("SELECT 1")
                return True
            except Exception as exc:
                logger.warning("db not ready (%s/%s): %s", attempt + 1, retries, exc)
                time.sleep(delay)
        return False


class Query:
    def __init__(self, session: "Session", model: type[Model]):
        self.session = session
        self.model = model
        self._where: list[Expr] = []
        self._order: list[str] = []
        self._limit: Optional[int] = None
        self._offset: Optional[int] = None

    def filter(self, *exprs: Expr) -> "Query":
        self._where.extend(exprs)
        return self

    def filter_by(self, **kwargs: Any) -> "Query":
        for key, value in kwargs.items():
            self._where.append(getattr(self.model, key) == value)
        return self

    def order_by(self, *clauses) -> "Query":
        for c in clauses:
            self._order.append(c if isinstance(c, str) else c.qualified)
        return self

    def limit(self, n: int) -> "Query":
        self._limit = n
        return self

    def offset(self, n: int) -> "Query":
        self._offset = n
        return self

    def _build(self, select: str) -> tuple[str, list[Any]]:
        sql = f"SELECT {select} FROM {self.model.__tablename__}"
        params: list[Any] = []
        if self._where:
            combined = self._where[0]
            for e in self._where[1:]:
                combined = combined & e
            sql += f" WHERE {combined.sql}"
            params += combined.params
        if self._order:
            sql += " ORDER BY " + ", ".join(self._order)
        if self._limit is not None:
            sql += f" LIMIT {int(self._limit)}"
        if self._offset is not None:
            sql += f" OFFSET {int(self._offset)}"
        return sql, params

    def all(self) -> list[Model]:
        sql, params = self._build("*")
        rows = self.session.execute(sql, params).fetchall()
        return [self.session._materialize(self.model, dict(r)) for r in rows]

    def first(self) -> Optional[Model]:
        self._limit = 1
        out = self.all()
        return out[0] if out else None

    def count(self) -> int:
        # ORDER BY is meaningless under COUNT(*) and LIMIT/OFFSET would
        # corrupt it (OFFSET past the single row -> fetchone() is None;
        # a prior first() leaves _limit=1) — strip all three for the
        # count and restore after
        order, self._order = self._order, []
        limit, self._limit = self._limit, None
        offset, self._offset = self._offset, None
        try:
            sql, params = self._build("COUNT(*) AS n")
        finally:
            self._order = order
            self._limit = limit
            self._offset = offset
        row = self.session.execute(sql, params).fetchone()
        return int(row["n"])

    def exists(self) -> bool:
        return self.count() > 0


class Session:
    def __init__(self, db: Database):
        self.db = db
        self.dialect = db.dialect
        self.conn = db.connect()
        self._identity: dict[tuple, Model] = {}
        self._snapshots: dict[tuple, dict[str, Any]] = {}
        self._pending: list[Model] = []
        self._closed = False
        # every session owns its connection now (in-memory DBs hand out
        # per-session connections to a shared-cache database)
        self._shared = False

    # -- raw ------------------------------------------------------------
    def execute(self, sql: str, params: Sequence[Any] = ()):
        from ics_tpu_torch.db.pg_wire import PGIntegrityError

        try:
            return self.conn.execute(sql, tuple(params))
        except sqlite3.IntegrityError as exc:
            raise IntegrityError(str(exc)) from exc
        except PGIntegrityError as exc:
            raise IntegrityError(str(exc)) from exc

    def fetchall(self, sql: str, params: Sequence[Any] = ()) -> list[dict]:
        return [dict(r) for r in self.execute(sql, params).fetchall()]

    def fetchone(self, sql: str, params: Sequence[Any] = ()) -> Optional[dict]:
        row = self.execute(sql, params).fetchone()
        return dict(row) if row is not None else None

    # -- identity map -----------------------------------------------------
    def _key(self, model: type[Model], pk: tuple) -> tuple:
        return (model.__tablename__, pk)

    def _materialize(self, model: type[Model], row: dict) -> Model:
        obj = model.from_row(row)
        key = self._key(model, obj.pk_tuple())
        existing = self._identity.get(key)
        if existing is not None:
            return existing
        self._identity[key] = obj
        self._snapshots[key] = obj.to_row()
        return obj

    # -- unit of work -------------------------------------------------------
    def add(self, obj: Model) -> None:
        self._pending.append(obj)

    def add_all(self, objs: Sequence[Model]) -> None:
        self._pending.extend(objs)

    def get(self, model: type[Model], *pk_values: Any) -> Optional[Model]:
        cols = model.__pk__
        if len(pk_values) != len(cols):
            raise ValueError(f"{model.__name__} pk needs {len(cols)} values")
        where = " AND ".join(f"{c} = ?" for c in cols)
        encoded = [
            model.__columns__[c].type.encode(v) for c, v in zip(cols, pk_values)
        ]
        row = self.fetchone(
            f"SELECT * FROM {model.__tablename__} WHERE {where}", encoded
        )
        return self._materialize(model, row) if row else None

    def query(self, model: type[Model]) -> Query:
        return Query(self, model)

    def delete(self, obj: Model) -> None:
        model = type(obj)
        # a just-added (unflushed) object must not be resurrected by the
        # later flush INSERT; the stale snapshot entry must go too
        if obj in self._pending:
            self._pending.remove(obj)
        where = " AND ".join(f"{c} = ?" for c in model.__pk__)
        self.execute(
            f"DELETE FROM {model.__tablename__} WHERE {where}", obj.pk_tuple()
        )
        key = self._key(model, obj.pk_tuple())
        self._identity.pop(key, None)
        self._snapshots.pop(key, None)

    def flush(self) -> None:
        for obj in self._pending:
            model = type(obj)
            row = obj.to_row()
            cols = ", ".join(row)
            marks = ", ".join("?" for _ in row)
            self.execute(
                f"INSERT INTO {model.__tablename__} ({cols}) VALUES ({marks})",
                list(row.values()),
            )
            key = self._key(model, obj.pk_tuple())
            self._identity[key] = obj
            self._snapshots[key] = row
        self._pending.clear()
        # dirty updates
        for key, obj in list(self._identity.items()):
            snapshot = self._snapshots.get(key)
            if snapshot is None:
                continue
            row = obj.to_row()
            changed = {k: v for k, v in row.items() if snapshot.get(k) != v}
            if not changed:
                continue
            model = type(obj)
            sets = ", ".join(f"{k} = ?" for k in changed)
            where = " AND ".join(f"{c} = ?" for c in model.__pk__)
            pk_encoded = [snapshot[c] for c in model.__pk__]
            self.execute(
                f"UPDATE {model.__tablename__} SET {sets} WHERE {where}",
                list(changed.values()) + pk_encoded,
            )
            self._snapshots[key] = row

    def commit(self) -> None:
        self.flush()
        self.conn.commit()

    def rollback(self) -> None:
        self._pending.clear()
        try:
            self.conn.rollback()
        except Exception:
            pass
        # drop cached state: it may not match the database any more
        self._identity.clear()
        self._snapshots.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self._shared:
            self.conn.close()


_default_db: Optional[Database] = None


def get_database(url: Optional[str] = None) -> Database:
    """Process-wide default database (lazily bound to settings)."""
    global _default_db
    if _default_db is None or (url is not None and _default_db.url != url):
        from ics_tpu_torch.core.config import settings

        _default_db = Database(url or settings.DATABASE_URL)
    return _default_db


def set_database(db: Database) -> None:
    global _default_db
    _default_db = db
