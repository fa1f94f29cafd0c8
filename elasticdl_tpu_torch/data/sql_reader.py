"""SQL table reader — the MaxCompute/ODPS reader equivalent.

The reference ships an ODPS (MaxCompute) table reader with schema
metadata, sharded range reads and a writer
(elasticdl/python/data/reader/odps_reader.py:27-120, data/odps_io.py).
The TPU-native build generalizes it to any DB-API database; sqlite3
(stdlib) works out of the box, and warehouse-specific drivers plug in via
``connection_factory``.  Shards are rowid ranges, so dynamic sharding and
task retries behave exactly like file readers.
"""

import sqlite3

import numpy as np

from elasticdl_tpu_torch.data.reader import AbstractDataReader


class SQLTableDataReader(AbstractDataReader):
    def __init__(self, database, table, columns=None,
                 records_per_shard=1000, connection_factory=None):
        self._database = database
        self._table = table
        self._records_per_shard = records_per_shard
        # check_same_thread=False: the worker's prefetch runs
        # read_records in a background thread.  Access is serialized in
        # the normal path (prefetch joins its producer before the next
        # task starts, data/parallel_reader.py); a wedged producer that
        # outlives the 60 s join could race a new one, so keep the
        # guard when the sqlite build does NOT fully serialize
        # connections.  Pre-3.11 the module reports a hardcoded
        # threadsafety of 1 regardless of the build, so trust CPython's
        # serialized default there.
        import sys

        _cst = (
            sys.version_info >= (3, 11) and sqlite3.threadsafety < 3
        )
        self._connect = connection_factory or (
            lambda: sqlite3.connect(database, check_same_thread=_cst)
        )
        self._conn = self._connect()
        cur = self._conn.execute("SELECT COUNT(*) FROM %s" % table)
        self._size = cur.fetchone()[0]
        if columns is None:
            cur = self._conn.execute(
                "SELECT * FROM %s LIMIT 1" % table
            )
            columns = [d[0] for d in cur.description]
        self._columns = columns

    @property
    def columns(self):
        return list(self._columns)

    def get_size(self):
        return self._size

    @property
    def records_per_shard(self):
        return self._records_per_shard

    def create_shards(self):
        shards = []
        start = 0
        while start < self._size:
            end = min(start + self._records_per_shard, self._size)
            shards.append((self._table, start, end))
            start = end
        return shards

    def read_records(self, task):
        if task.shard.record_indices:
            # Shuffled task: the indices are a permutation of the
            # shard's own range, so fetch the covering range in ONE
            # query and reorder in memory — per-index OFFSET queries
            # would rescan the table once per record.
            indices = [int(i) for i in task.shard.record_indices]
            lo, hi = min(indices), max(indices) + 1
            cur = self._conn.execute(
                "SELECT %s FROM %s LIMIT ? OFFSET ?"
                % (", ".join(self._columns), self._table),
                (hi - lo, lo),
            )
            rows = cur.fetchall()
            for i in indices:
                if 0 <= i - lo < len(rows):
                    yield list(rows[i - lo])
            return
        start, end = task.shard.start, task.shard.end
        cur = self._conn.execute(
            "SELECT %s FROM %s LIMIT ? OFFSET ?"
            % (", ".join(self._columns), self._table),
            (end - start, start),
        )
        for row in cur:
            yield list(row)


class SQLTableWriter:
    """Row writer (reference ODPSWriter parity) — batch inserts."""

    def __init__(self, database, table, columns,
                 connection_factory=None):
        self._connect = connection_factory or (
            lambda: sqlite3.connect(database)
        )
        self._conn = self._connect()
        self._table = table
        self._columns = columns
        cols = ", ".join("%s" % c for c in columns)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS %s (%s)" % (table, cols)
        )
        self._insert_sql = "INSERT INTO %s (%s) VALUES (%s)" % (
            table, cols, ", ".join("?" for _ in columns)
        )

    def write(self, rows):
        self._conn.executemany(
            self._insert_sql,
            [tuple(np.asarray(r).tolist()) for r in rows],
        )
        self._conn.commit()

    def close(self):
        self._conn.close()
