"""A lightweight data-mapper ORM.

The reference used SQLAlchemy (not available in this image); this module is
the framework's own persistence mapper, sized to what the system needs:

- declarative models (``Column`` descriptors collected by a metaclass)
- typed columns (Uuid, String, Char, Text, Integer, Boolean, DateTime, JSONB)
  with sqlite/postgres encode/decode
- expression objects for WHERE clauses (``Model.col == x``, ``.in_``,
  comparisons, ``and_`` / ``or_``) — enough for soft-delete filters and
  keyset pagination
- DDL generation (``create table`` / indexes) used by ``create_all`` and the
  migration engine

Complex reporting queries stay as explicit SQL in the CRUD layer — by
design: this is a data mapper, not a query compiler.
"""

from __future__ import annotations

import json
import uuid as _uuid
from datetime import datetime, timezone as _tz
from typing import Any, Callable, Optional

# --------------------------------------------------------------------------
# Column types
# --------------------------------------------------------------------------


class TypeSpec:
    sqlite_type = "TEXT"

    def encode(self, value: Any) -> Any:
        return value

    def decode(self, value: Any) -> Any:
        return value


class Integer(TypeSpec):
    sqlite_type = "INTEGER"


class Float(TypeSpec):
    sqlite_type = "REAL"

    def decode(self, value):
        if value is None:
            return None
        return float(value)


class Boolean(TypeSpec):
    sqlite_type = "INTEGER"

    def encode(self, value):
        if value is None:
            return None
        return 1 if value else 0

    def decode(self, value):
        if value is None:
            return None
        return bool(value)


class String(TypeSpec):
    def __init__(self, length: int = 255):
        self.length = length


class Char(String):
    pass


class Text(TypeSpec):
    pass


class Uuid(TypeSpec):
    """Stored as 36-char text; surfaces as str (uuid identity by value)."""

    def encode(self, value):
        if value is None:
            return None
        return str(value)

    def decode(self, value):
        return value


class DateTime(TypeSpec):
    """Stored as ISO-8601 UTC text; surfaces as aware datetime."""

    def encode(self, value):
        if value is None:
            return None
        if isinstance(value, str):
            # normalize string inputs too: the storage invariant is
            # aware-UTC ISO text that sorts lexicographically (CLAUDE.md)
            # — a '-03:00' offset or naive string passed through verbatim
            # would sort incorrectly against '+00:00' rows, silently
            # breaking keyset pagination (self-review r3)
            value = datetime.fromisoformat(value)
        if value.tzinfo is None:
            value = value.replace(tzinfo=_tz.utc)
        return value.astimezone(_tz.utc).isoformat()

    def decode(self, value):
        if value is None or isinstance(value, datetime):
            return value
        dt = datetime.fromisoformat(value)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_tz.utc)
        return dt


class JSONB(TypeSpec):
    def encode(self, value):
        if value is None:
            return None
        return json.dumps(value, ensure_ascii=False, default=str)

    def decode(self, value):
        if value is None or not isinstance(value, str):
            return value
        return json.loads(value)


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


class Expr:
    """WHERE-clause fragment: SQL text with ordered params."""

    def __init__(self, sql: str, params: list[Any]):
        self.sql = sql
        self.params = params

    def __and__(self, other: "Expr") -> "Expr":
        return Expr(f"({self.sql} AND {other.sql})", self.params + other.params)

    def __or__(self, other: "Expr") -> "Expr":
        return Expr(f"({self.sql} OR {other.sql})", self.params + other.params)


def and_(*exprs: Expr) -> Expr:
    out = exprs[0]
    for e in exprs[1:]:
        out = out & e
    return out


def or_(*exprs: Expr) -> Expr:
    out = exprs[0]
    for e in exprs[1:]:
        out = out | e
    return out


class Column:
    """Descriptor + schema definition + expression factory."""

    def __init__(
        self,
        type_: TypeSpec | type,
        primary_key: bool = False,
        nullable: bool = True,
        unique: bool = False,
        index: bool = False,
        default: Any = None,
        foreign_key: Optional[str] = None,   # "table.column"
        ondelete: Optional[str] = None,
    ):
        self.type = type_() if isinstance(type_, type) else type_
        self.primary_key = primary_key
        self.nullable = nullable and not primary_key
        self.unique = unique
        self.index = index
        self.default = default
        self.foreign_key = foreign_key
        self.ondelete = ondelete
        self.name: str = ""          # set by metaclass
        self.table: str = ""

    # descriptor protocol ---------------------------------------------------
    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return instance.__dict__.get(self.name)

    def __set__(self, instance, value):
        instance.__dict__[self.name] = value

    # expression factory ----------------------------------------------------
    @property
    def qualified(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name

    def _coerce(self, value: Any) -> Any:
        return self.type.encode(value)

    def __eq__(self, other):  # type: ignore[override]
        if other is None:
            return Expr(f"{self.qualified} IS NULL", [])
        return Expr(f"{self.qualified} = ?", [self._coerce(other)])

    def __ne__(self, other):  # type: ignore[override]
        if other is None:
            return Expr(f"{self.qualified} IS NOT NULL", [])
        return Expr(f"{self.qualified} != ?", [self._coerce(other)])

    def __lt__(self, other):
        return Expr(f"{self.qualified} < ?", [self._coerce(other)])

    def __le__(self, other):
        return Expr(f"{self.qualified} <= ?", [self._coerce(other)])

    def __gt__(self, other):
        return Expr(f"{self.qualified} > ?", [self._coerce(other)])

    def __ge__(self, other):
        return Expr(f"{self.qualified} >= ?", [self._coerce(other)])

    def in_(self, values) -> Expr:
        vals = [self._coerce(v) for v in values]
        if not vals:
            return Expr("1 = 0", [])
        marks = ", ".join("?" for _ in vals)
        return Expr(f"{self.qualified} IN ({marks})", vals)

    def is_(self, value) -> Expr:
        if value is None:
            return Expr(f"{self.qualified} IS NULL", [])
        return self == value

    def like(self, pattern: str) -> Expr:
        return Expr(f"{self.qualified} LIKE ?", [pattern])

    def asc(self) -> str:
        return f"{self.qualified} ASC"

    def desc(self) -> str:
        return f"{self.qualified} DESC"

    def __hash__(self):
        return hash((self.table, self.name))


class Index:
    def __init__(self, name: str, *columns: str, unique: bool = False):
        self.name = name
        self.columns = columns
        self.unique = unique


# --------------------------------------------------------------------------
# Model base
# --------------------------------------------------------------------------

MODEL_REGISTRY: dict[str, type] = {}


class ModelMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        if ns.get("__abstract__"):
            return cls
        tablename = ns.get("__tablename__")
        if tablename is None:
            return cls
        columns: dict[str, Column] = {}
        for base in reversed(cls.__mro__):
            for key, val in vars(base).items():
                if isinstance(val, Column):
                    columns[key] = val
        for key, col in columns.items():
            col.table = tablename
        cls.__columns__ = columns
        cls.__pk__ = [k for k, c in columns.items() if c.primary_key]
        cls.__indexes__ = list(ns.get("__table_args__", ()))
        MODEL_REGISTRY[tablename] = cls
        return cls


class Model(metaclass=ModelMeta):
    __abstract__ = True
    __tablename__: str = None  # type: ignore
    __columns__: dict[str, Column]
    __pk__: list[str]

    def __init__(self, **kwargs):
        for key, col in self.__columns__.items():
            if key in kwargs:
                value = kwargs.pop(key)
            elif col.default is not None:
                d = col.default
                value = d() if callable(d) else d
            else:
                value = None
            self.__dict__[key] = value
        if kwargs:
            raise TypeError(
                f"unknown columns for {type(self).__name__}: {sorted(kwargs)}"
            )

    # -- mapping helpers ----------------------------------------------------
    def pk_tuple(self) -> tuple:
        return tuple(
            self.__columns__[k].type.encode(self.__dict__.get(k)) for k in self.__pk__
        )

    def to_row(self) -> dict[str, Any]:
        return {
            k: col.type.encode(self.__dict__.get(k))
            for k, col in self.__columns__.items()
        }

    @classmethod
    def from_row(cls, row: dict[str, Any]) -> "Model":
        obj = cls.__new__(cls)
        for k, col in cls.__columns__.items():
            obj.__dict__[k] = col.type.decode(row.get(k))
        return obj

    def to_dict(self) -> dict[str, Any]:
        return {k: self.__dict__.get(k) for k in self.__columns__}

    def __repr__(self):
        pk = {k: self.__dict__.get(k) for k in self.__pk__}
        return f"<{type(self).__name__} {pk}>"


def new_uuid() -> str:
    return str(_uuid.uuid4())


# --------------------------------------------------------------------------
# DDL
# --------------------------------------------------------------------------


def _column_ddl(name: str, col: Column) -> str:
    # PK constraint is emitted at table level (supports composite keys)
    parts = [name, col.type.sqlite_type]
    if not col.nullable and not col.primary_key:
        parts.append("NOT NULL")
    if col.unique and not col.primary_key:
        parts.append("UNIQUE")
    if col.foreign_key:
        ref_table, _, ref_col = col.foreign_key.partition(".")
        clause = f"REFERENCES {ref_table}({ref_col})"
        if col.ondelete:
            clause += f" ON DELETE {col.ondelete}"
        parts.append(clause)
    return " ".join(parts)


def models_in_fk_order() -> list[type]:
    """MODEL_REGISTRY values topologically sorted so every REFERENCES
    target table is created before its referrers.

    PostgreSQL validates FK targets at CREATE TABLE time, so definition
    order aborts the bootstrap ('relation "imagens" does not exist');
    sqlite resolves FKs lazily, which is why only the PG dialect ever
    notices (self-review r3)."""
    by_table = {m.__tablename__: m for m in MODEL_REGISTRY.values()}
    deps = {
        t: {
            c.foreign_key.partition(".")[0]
            for c in m.__columns__.values()
            if c.foreign_key
            and c.foreign_key.partition(".")[0] != t  # self-FK is fine
        } & set(by_table)
        for t, m in by_table.items()
    }
    ordered: list[type] = []
    done: set[str] = set()
    while len(ordered) < len(by_table):
        progressed = False
        for t, m in by_table.items():
            if t not in done and deps[t] <= done:
                ordered.append(m)
                done.add(t)
                progressed = True
        if not progressed:  # pragma: no cover - schema bug guard
            raise ValueError(
                f"ciclo de FKs entre tabelas: {set(by_table) - done}"
            )
    return ordered


def create_table_sql(model: type[Model]) -> list[str]:
    cols = [_column_ddl(k, c) for k, c in model.__columns__.items()]
    pk = ", ".join(model.__pk__)
    cols.append(f"PRIMARY KEY ({pk})")
    stmts = [
        f"CREATE TABLE IF NOT EXISTS {model.__tablename__} (\n  "
        + ",\n  ".join(cols)
        + "\n)"
    ]
    for k, c in model.__columns__.items():
        if c.index and not c.primary_key:
            stmts.append(
                f"CREATE INDEX IF NOT EXISTS idx_{model.__tablename__}_{k} "
                f"ON {model.__tablename__} ({k})"
            )
    for idx in getattr(model, "__indexes__", []):
        unique = "UNIQUE " if idx.unique else ""
        stmts.append(
            f"CREATE {unique}INDEX IF NOT EXISTS {idx.name} "
            f"ON {model.__tablename__} ({', '.join(idx.columns)})"
        )
    return stmts
