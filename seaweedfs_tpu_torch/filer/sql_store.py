"""Shared-SQL FilerStore layer + dialects.

Reference: weed/filer/abstract_sql/abstract_sql_store.go — one store
implementation parameterized by an SQL dialect, backing the mysql/
mysql2/postgres/postgres2/sqlite reference directories. Here
`AbstractSqlStore` holds every query/mutation; a `SqlDialect` contributes
connections, parameter style, and the statements whose syntax differs
between engines (upsert, blob type, prefix match). SqliteStore (stdlib)
is the always-available dialect; MySQL/Postgres dialects carry the
reference DSN behavior and activate when their drivers are importable
(this image ships none — the conformance suite drives the abstract layer
through a semantic in-process DB-API double instead).

The port's copy of seaweedfs_tpu/filer/sql_store.py, unchanged: the same
schema, so a sqlite filer db written by either package opens in the other.
The MySQL and Postgres drivers are optional: the port does not depend on them.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator

from ..pb import filer_pb2 as fpb
from .store import FilerStore


class SqlDialect:
    """Connection factory + engine-specific SQL fragments."""

    #: DB-API param placeholder ('?' for sqlite, '%s' for mysql/pg)
    placeholder = "?"

    CREATE_TABLES = (
        """CREATE TABLE IF NOT EXISTS filemeta(
            directory TEXT NOT NULL, name TEXT NOT NULL, meta BLOB,
            PRIMARY KEY(directory, name))""",
        "CREATE TABLE IF NOT EXISTS kv(k BLOB PRIMARY KEY, v BLOB)",
    )
    UPSERT_ENTRY = ("INSERT INTO filemeta(directory,name,meta) "
                    "VALUES({p},{p},{p}) ON CONFLICT(directory,name) "
                    "DO UPDATE SET meta=excluded.meta")
    UPSERT_KV = ("INSERT INTO kv(k,v) VALUES({p},{p}) "
                 "ON CONFLICT(k) DO UPDATE SET v=excluded.v")
    FIND_ENTRY = "SELECT meta FROM filemeta WHERE directory={p} AND name={p}"
    DELETE_ENTRY = "DELETE FROM filemeta WHERE directory={p} AND name={p}"
    DELETE_CHILDREN = "DELETE FROM filemeta WHERE directory={p}"
    # LIKE + ESCAPE '|' is portable across sqlite/mysql/postgres (a
    # backslash escape char would itself be string-escaped by MySQL)
    LIST = ("SELECT meta FROM filemeta WHERE directory={p} AND name {op} {p}"
            "{prefix_clause} ORDER BY name LIMIT {p}")
    LIST_PREFIX_CLAUSE = " AND name LIKE {p} ESCAPE '|'"
    GET_KV = "SELECT v FROM kv WHERE k={p}"

    def connect(self):
        raise NotImplementedError

    def sql(self, template: str, **extra: str) -> str:
        return template.format(p=self.placeholder, **extra)


class SqliteDialect(SqlDialect):
    name = "sqlite"

    def __init__(self, path: str):
        self.path = path

    def connect(self):
        c = sqlite3.connect(self.path, timeout=30)
        c.execute("PRAGMA journal_mode=WAL")
        c.execute("PRAGMA synchronous=NORMAL")
        # LIKE defaults to case-insensitive in sqlite; prefix listings
        # must be byte-exact (the python-side re-filter is the backstop)
        c.execute("PRAGMA case_sensitive_like=ON")
        return c


class MysqlDialect(SqlDialect):
    """Reference filer.toml [mysql] section; needs a pymysql install."""

    name = "mysql"
    placeholder = "%s"
    # VARBINARY keys: byte-length (not chars x4 under utf8mb4), so the
    # composite PK fits InnoDB's 3072-byte index cap, and comparisons/
    # LIKE are binary-exact like every other backend
    CREATE_TABLES = (
        """CREATE TABLE IF NOT EXISTS filemeta(
            directory VARBINARY(760) NOT NULL, name VARBINARY(760) NOT NULL,
            meta LONGBLOB, PRIMARY KEY(directory, name))""",
        """CREATE TABLE IF NOT EXISTS kv(
            k VARBINARY(512) PRIMARY KEY, v LONGBLOB)""",
    )
    UPSERT_ENTRY = ("INSERT INTO filemeta(directory,name,meta) "
                    "VALUES({p},{p},{p}) "
                    "ON DUPLICATE KEY UPDATE meta=VALUES(meta)")
    UPSERT_KV = ("INSERT INTO kv(k,v) VALUES({p},{p}) "
                 "ON DUPLICATE KEY UPDATE v=VALUES(v)")

    def __init__(self, host="127.0.0.1", port=3306, user="root",
                 password="", database="seaweedfs"):
        self.kw = dict(host=host, port=port, user=user, password=password,
                       database=database)

    def connect(self):
        try:
            import pymysql  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "mysql filer store needs the pymysql driver (not shipped "
                "in this image); use sqlite/lsm/redis instead") from e
        return pymysql.connect(autocommit=False, **self.kw)


class PostgresDialect(SqlDialect):
    """Reference filer.toml [postgres] section; needs a psycopg install."""

    name = "postgres"
    placeholder = "%s"
    CREATE_TABLES = (
        """CREATE TABLE IF NOT EXISTS filemeta(
            directory TEXT NOT NULL, name TEXT NOT NULL, meta BYTEA,
            PRIMARY KEY(directory, name))""",
        "CREATE TABLE IF NOT EXISTS kv(k BYTEA PRIMARY KEY, v BYTEA)",
    )
    UPSERT_ENTRY = ("INSERT INTO filemeta(directory,name,meta) "
                    "VALUES({p},{p},{p}) ON CONFLICT(directory,name) "
                    "DO UPDATE SET meta=EXCLUDED.meta")
    UPSERT_KV = ("INSERT INTO kv(k,v) VALUES({p},{p}) "
                 "ON CONFLICT(k) DO UPDATE SET v=EXCLUDED.v")

    def __init__(self, dsn: str = "dbname=seaweedfs"):
        self.dsn = dsn

    def connect(self):
        try:
            import psycopg2  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "postgres filer store needs the psycopg2 driver (not "
                "shipped in this image); use sqlite/lsm/redis instead") from e
        return psycopg2.connect(self.dsn)


def _escape_like(prefix: str) -> str:
    return (prefix.replace("|", "||").replace("%", "|%")
            .replace("_", "|_"))


class AbstractSqlStore(FilerStore):
    """All filer CRUD in terms of a SqlDialect (abstract_sql analogue)."""

    name = "sql"

    def __init__(self, dialect: SqlDialect):
        self.dialect = dialect
        self.name = getattr(dialect, "name", "sql")
        self._local = threading.local()
        self._init_schema()

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self.dialect.connect()
            self._local.conn = c
        return c

    def _init_schema(self):
        c = self._conn()
        cur = c.cursor()
        for stmt in self.dialect.CREATE_TABLES:
            cur.execute(stmt)
        c.commit()

    def _exec(self, template: str, params: tuple, **extra) -> None:
        c = self._conn()
        c.cursor().execute(self.dialect.sql(template, **extra), params)
        c.commit()

    def insert_entry(self, directory, entry):
        self._exec(self.dialect.UPSERT_ENTRY,
                   (directory, entry.name, entry.SerializeToString()))

    update_entry = insert_entry

    def find_entry(self, directory, name):
        cur = self._conn().cursor()
        cur.execute(self.dialect.sql(self.dialect.FIND_ENTRY),
                    (directory, name))
        row = cur.fetchone()
        if row is None:
            return None
        e = fpb.Entry()
        e.ParseFromString(bytes(row[0]))
        return e

    def delete_entry(self, directory, name):
        self._exec(self.dialect.DELETE_ENTRY, (directory, name))

    def delete_folder_children(self, directory):
        self._exec(self.dialect.DELETE_CHILDREN, (directory,))

    def list_entries(self, directory, start_from="", inclusive=False,
                     limit=2**31, prefix="") -> Iterator[fpb.Entry]:
        op = ">=" if inclusive else ">"
        params: list = [directory, start_from]
        clause = ""
        if prefix:
            clause = self.dialect.sql(self.dialect.LIST_PREFIX_CLAUSE)
            params.append(_escape_like(prefix) + "%")
        params.append(min(limit, 2**31 - 1))
        cur = self._conn().cursor()
        cur.execute(self.dialect.sql(self.dialect.LIST, op=op,
                                     prefix_clause=clause), params)
        # stream rows from the cursor: fetchall() would materialize an
        # entire huge directory in memory (the SqliteStore this layer
        # replaced was O(batch))
        while True:
            rows = cur.fetchmany(256)
            if not rows:
                return
            for (blob,) in rows:
                e = fpb.Entry()
                e.ParseFromString(bytes(blob))
                if prefix and not e.name.startswith(prefix):
                    continue  # backstop for collation-insensitive LIKE
                yield e

    def kv_get(self, key):
        cur = self._conn().cursor()
        cur.execute(self.dialect.sql(self.dialect.GET_KV), (key,))
        row = cur.fetchone()
        return bytes(row[0]) if row else None

    def kv_put(self, key, value):
        self._exec(self.dialect.UPSERT_KV, (key, value))

    def close(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None
