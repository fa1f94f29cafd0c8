"""`recio` — a minimal length-prefixed binary record format.

The TPU-native stand-in for the reference's RecordIO dependency
(elasticdl/python/data/reader/recordio_reader.py:27-63): sequential records,
random access by record index, one file per shard.  Format:

    magic b"ETPR" | uint32 version | records: (uint32 length | payload)*

Record offsets are recovered with a single sequential scan at open time and
cached, giving O(1) seeks for [start, end) shard reads.
"""

import io
import os
import struct

MAGIC = b"ETPR"
VERSION = 1
_LEN = struct.Struct("<I")


class RecioWriter:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(_LEN.pack(VERSION))

    def write(self, payload):
        if not isinstance(payload, (bytes, bytearray)):
            raise TypeError("recio records are bytes, got %r" % type(payload))
        self._f.write(_LEN.pack(len(payload)))
        self._f.write(payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecioReader:
    def __init__(self, path):
        self._path = path
        self._f = open(path, "rb")
        header = self._f.read(8)
        if header[:4] != MAGIC:
            raise ValueError("not a recio file: %s" % path)
        self._offsets = []
        self._scan()

    def _scan(self):
        f = self._f
        f.seek(8, io.SEEK_SET)
        size = os.fstat(f.fileno()).st_size
        pos = 8
        while pos < size:
            self._offsets.append(pos)
            (length,) = _LEN.unpack(f.read(4))
            pos += 4 + length
            f.seek(pos, io.SEEK_SET)

    def __len__(self):
        return len(self._offsets)

    def read(self, index):
        self._f.seek(self._offsets[index], io.SEEK_SET)
        (length,) = _LEN.unpack(self._f.read(4))
        return self._f.read(length)

    def read_range(self, start, end):
        for i in range(start, min(end, len(self._offsets))):
            yield self.read(i)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
