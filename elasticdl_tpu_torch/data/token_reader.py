"""Memory-mapped binary token files — the LM-native data path.

The GPT-style pretraining layout: a flat binary file of token ids
(uint16 for vocab <= 65536, uint32 otherwise), read as fixed-length
non-overlapping windows.  TPU-first properties:

 - **Zero-copy reads**: ``np.memmap`` — a task's window slice touches
   only its own pages; no parse, no decode, no Python-object records.
   One 4-byte-token 2048-seq record is 8 KB of sequential IO.
 - **Exact dynamic sharding**: a record IS a window, so the task
   stream's [start, end) ranges map to byte offsets directly — any
   worker can serve any shard, and elastic re-queues lose nothing.
 - **Resume-friendly**: skip_records (master resume) is a pure index
   offset.

Factory origin: ``tokens:<path>:<seq_len>[:<dtype>]`` (dtype uint16 |
uint32, default uint16).  ``write_token_file`` is the matching writer
(tokenizer output -> training file).

Parity: the role of the reference's RecordIO/Text readers
(data/reader/data_reader.py:65-105) for the token-stream modality the
reference never had.
"""

import os

import numpy as np

from elasticdl_tpu_torch.data.reader import AbstractDataReader


def write_token_file(path, tokens, dtype=np.uint16):
    """Append-or-create a flat binary token file from an id array.

    The format is headerless, so a mixed-dtype append would silently
    byte-misalign every later window: the dtype used at creation is
    recorded in a ``<path>.meta`` sidecar and appends must match it.
    """
    tokens = np.asarray(tokens)
    if tokens.size == 0:
        return  # empty document in a tokenize-and-append loop
    dtype = np.dtype(dtype)
    meta_path = path + ".meta"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            recorded = f.read().strip()
        if recorded != dtype.name:
            raise ValueError(
                "token file %s was created with dtype %s; appending "
                "%s would corrupt it" % (path, recorded, dtype.name))
    else:
        with open(meta_path, "w") as f:
            f.write(dtype.name)
    info = np.iinfo(dtype)
    if tokens.min() < info.min or tokens.max() > info.max:
        raise ValueError(
            "token ids [%d, %d] exceed %s range"
            % (tokens.min(), tokens.max(), dtype.name))
    with open(path, "ab") as f:
        tokens.astype(dtype).ravel().tofile(f)


class TokenFileDataReader(AbstractDataReader):
    def __init__(self, path, seq_len, dtype=np.uint16,
                 records_per_shard=256):
        self._path = path
        self._seq_len = int(seq_len)
        self._dtype = np.dtype(dtype)
        meta_path = path + ".meta"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                recorded = f.read().strip()
            if recorded != self._dtype.name:
                raise ValueError(
                    "token file %s records dtype %s (sidecar); reader "
                    "asked for %s" % (path, recorded, self._dtype.name))
        self._records_per_shard = records_per_shard
        n_tokens = os.path.getsize(path) // self._dtype.itemsize
        # trailing partial window is dropped (a short record would
        # break the static [B, T] shape every jitted step relies on)
        self._num_records = n_tokens // self._seq_len
        self._mmap = None

    @property
    def records_per_shard(self):
        return self._records_per_shard

    def create_shards(self):
        shards = []
        for start in range(0, self._num_records,
                           self._records_per_shard):
            end = min(start + self._records_per_shard,
                      self._num_records)
            shards.append((self._path, start, end))
        return shards

    def read_records(self, task):
        if self._mmap is None:
            # Lazy: workers construct the reader before forking
            # subprocesses; an inherited mmap handle is not fork-safe.
            self._mmap = np.memmap(self._path, dtype=self._dtype,
                                   mode="r")
        T = self._seq_len
        # record_indices: the task manager's shuffle permutation (and
        # its resume-trimmed tail) — every reader must honor it or
        # --shuffle silently no-ops and resume diverges.
        indices = task.shard.record_indices or range(
            task.shard.start, task.shard.end)
        n_tokens = len(self._mmap)
        for idx in indices:
            # Fail loudly on a truncated file or stale shard range: a
            # silent short slice would break the static [B, T] batch
            # shape downstream (ADVICE r5 low).
            if idx < 0 or (idx + 1) * T > n_tokens:
                raise ValueError(
                    "token shard window %d of %s is out of range: "
                    "[%d:%d) exceeds the file's %d tokens — truncated "
                    "file or stale shard metadata?"
                    % (idx, self._path, idx * T, (idx + 1) * T,
                       n_tokens))
            window = self._mmap[idx * T:(idx + 1) * T]
            yield (np.asarray(window, dtype=np.int32),)
