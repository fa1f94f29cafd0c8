"""Data readers: map a task's shard to a record stream.

Same contract as the reference's AbstractDataReader
(elasticdl/python/data/reader/data_reader.py:65-105): ``create_shards`` tells
the TaskManager how to partition the dataset; ``read_records`` streams the
records of one task's [start, end) range.  Readers are deliberately
numpy-first: records decode to ndarrays that feed straight into jitted steps.
"""

import abc
import csv
import glob
import os

import numpy as np

from elasticdl_tpu_torch.data.recio import RecioReader


class AbstractDataReader(abc.ABC):
    @abc.abstractmethod
    def create_shards(self):
        """Return a list of (name, start, end) record ranges."""

    @abc.abstractmethod
    def read_records(self, task):
        """Yield records for task.shard's [start, end) range."""

    @property
    def records_per_shard(self):
        return None


class RecioDataReader(AbstractDataReader):
    """One shard per recio file (reference: recordio_reader.py:27-63)."""

    def __init__(self, data_dir, decode_fn=None):
        self._data_dir = data_dir
        self._decode_fn = decode_fn
        self._readers = {}

    def _reader(self, name):
        if name not in self._readers:
            self._readers[name] = RecioReader(name)
        return self._readers[name]

    def create_shards(self):
        from elasticdl_tpu_torch.data.recio import MAGIC

        shards = []
        for path in sorted(glob.glob(os.path.join(self._data_dir, "*"))):
            if not os.path.isfile(path):
                continue
            with open(path, "rb") as f:
                if f.read(4) != MAGIC:
                    continue  # skip non-recio files in mixed dirs
            shards.append((path, 0, len(self._reader(path))))
        return shards

    def read_records(self, task):
        reader = self._reader(task.shard.name)
        if task.shard.record_indices:
            # Shuffled task: the offset index gives O(1) random access, so
            # honor the master's permutation instead of the linear range.
            records = (reader.read(i) for i in task.shard.record_indices)
        else:
            records = reader.read_range(task.shard.start, task.shard.end)
        for payload in records:
            yield self._decode_fn(payload) if self._decode_fn else payload


class TextDataReader(AbstractDataReader):
    """CSV reader with fixed-size shards (reference: text_reader.py:25-72).

    Only a byte-offset index is held in memory (~8 B/line); record reads
    seek into the file, so per-process memory stays proportional to one
    task regardless of file size.
    """

    def __init__(self, filename, records_per_task=200, skip_header=False):
        self._filename = filename
        self._records_per_task = records_per_task
        self._offsets = []
        with open(filename, "rb") as f:
            if skip_header:
                f.readline()
            pos = f.tell()
            for line in f:
                self._offsets.append(pos)
                pos += len(line)
        self._f = open(filename, "rb")

    def create_shards(self):
        n = len(self._offsets)
        shards = []
        start = 0
        while start < n:
            end = min(start + self._records_per_task, n)
            shards.append((self._filename, start, end))
            start = end
        return shards

    def read_records(self, task):
        indices = task.shard.record_indices or range(
            task.shard.start, min(task.shard.end, len(self._offsets))
        )
        lines = []
        for i in indices:
            if i < len(self._offsets):
                self._f.seek(self._offsets[i])
                lines.append(self._f.readline().decode("utf-8"))
        yield from csv.reader(lines)

    def get_size(self):
        return len(self._offsets)


class ArrayDataReader(AbstractDataReader):
    """In-memory ndarray dataset; shards are index ranges.

    The natural TPU-side reader for benchmark/synthetic data: records are
    (x, y) ndarray tuples and never leave host memory until the batch is
    device_put as one contiguous block.
    """

    def __init__(self, arrays, records_per_shard=1024, name="memory"):
        self._arrays = tuple(np.asarray(a) for a in arrays)
        n = self._arrays[0].shape[0]
        if any(a.shape[0] != n for a in self._arrays):
            raise ValueError("all arrays must share dim 0")
        self._n = n
        self._records_per_shard = records_per_shard
        self._name = name

    @property
    def records_per_shard(self):
        return self._records_per_shard

    def create_shards(self):
        shards = []
        start = 0
        while start < self._n:
            end = min(start + self._records_per_shard, self._n)
            shards.append((self._name, start, end))
            start = end
        return shards

    def read_records(self, task):
        indices = task.shard.record_indices
        if indices:
            for i in indices:
                yield tuple(a[i] for a in self._arrays)
        else:
            for i in range(task.shard.start, task.shard.end):
                yield tuple(a[i] for a in self._arrays)
