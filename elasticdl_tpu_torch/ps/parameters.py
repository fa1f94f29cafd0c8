"""Parameter-server state: dense params + native embedding tables.

Parity with elasticdl/python/ps/parameters.py:30-224 and the Go model store
(go/pkg/ps/model.go:25-110), with the embedding rows living in the C++
store (native/kernels.cc) rather than Python dicts.
"""

import threading

import numpy as np

from elasticdl_tpu_torch.native.bindings import NativeEmbeddingTable
from elasticdl_tpu_torch.utils import hashing, tensor_codec
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def slot_table_name(layer_name, slot_name):
    return "%s-%s" % (layer_name, slot_name)


class Parameters:
    def __init__(self):
        self.version = 0
        self.initialized = False
        self.dense = {}             # name -> np.float32 array
        self.embeddings = {}        # name -> NativeEmbeddingTable
        self.embedding_infos = {}   # name -> info dict
        self.slot_tables = {}       # slot table name -> NativeEmbeddingTable
        # RLock: init_from_model_pb holds it across set_embedding_infos.
        # This lock makes Parameters internally consistent (init,
        # restore, checkpoint payload, table registry); per-row
        # embedding traffic stays on the native tables' rw-lock, and
        # gradient APPLIES are serialized one level up by the
        # servicer's lock (ps/servicer.py).
        self._lock = threading.RLock()

    # -- init ---------------------------------------------------------------

    def init_from_model_pb(self, model_pb):
        """First worker push initializes the shard (reference
        go/pkg/ps/server.go:209-221)."""
        with self._lock:
            if self.initialized:
                return False
            dense, embeddings, infos, version = tensor_codec.pb_to_model(
                model_pb
            )
            for name, arr in dense.items():
                self.dense[name] = np.array(arr, np.float32, copy=True)
            self.set_embedding_infos(infos)
            for name, (values, ids) in embeddings.items():
                self.embeddings[name].set(ids, values)
            self.version = max(self.version, version)
            self.initialized = True
            logger.info(
                "parameters initialized: %d dense, %d embedding tables",
                len(self.dense), len(self.embeddings),
            )
            return True

    def set_embedding_infos(self, infos):
        with self._lock:
            self._set_embedding_infos_locked(infos)

    def _set_embedding_infos_locked(self, infos):
        for info in infos:
            name = info["name"]
            if name in self.embeddings:
                continue
            self.embedding_infos[name] = info
            initializer = info.get("initializer", "uniform")
            kwargs = {}
            if initializer.startswith("constant("):
                kwargs = {"init_a": float(initializer[9:-1])}
                initializer = "constant"
            elif initializer == "uniform":
                kwargs = {"init_a": -0.05, "init_b": 0.05}
            elif initializer == "normal":
                kwargs = {"init_a": 0.0, "init_b": 0.05}
            # Stable hash, NOT builtin hash(): str hashing is
            # randomized per process, which made lazy-row init differ
            # across shard restarts (and made same-seed runs
            # irreproducible across PS processes).
            self.embeddings[name] = NativeEmbeddingTable(
                info["dim"], initializer,
                seed=hashing.string_to_id(name, 0x10000),
                **kwargs,
            )

    def create_slot_tables(self, slot_names):
        """Per-slot shadow tables (reference
        python/ps/parameters.py:169-183): zeros-initialized, same dim."""
        with self._lock:
            for name, table in self.embeddings.items():
                for slot in slot_names:
                    key = slot_table_name(name, slot)
                    if key not in self.slot_tables:
                        self.slot_tables[key] = NativeEmbeddingTable(
                            table.dim, "zeros"
                        )

    # -- access -------------------------------------------------------------

    def get_dense(self):
        # Returned by reference, deliberately without this class's
        # lock (which would synchronize nothing here): values are
        # updated in place by the optimizer under the SERVICER lock,
        # and callers iterate under that same lock (see the elastic-
        # lint baseline entry).
        return self.dense

    def pull_embedding_vectors(self, name, ids):
        # Only the registry lookup needs the lock; the row reads run
        # concurrently on the native table's rw-lock (the hot RPC must
        # not serialize behind init/restore/checkpoint).
        with self._lock:
            table = self.embeddings[name]
        if np.size(ids) == 0:
            # Preserve the row dim on empty pulls — (0, 0) breaks
            # downstream shape assumptions (worker padding, concat).
            return np.zeros((0, table.dim), np.float32)
        return table.get(ids)

    def lookup_embedding_rows(self, name, ids, default=0.0):
        """Read-only variant of :meth:`pull_embedding_vectors` for the
        SERVING lookup path: absent ids come back as ``default`` rows
        and are never lazily initialized, so serving traffic (arbitrary
        ids from the internet) cannot grow the training table or
        perturb its id set.  Same per-row atomicity as the training
        pull (the native table's rw-lock); runs entirely under the
        shared lock, so lookups never serialize behind each other."""
        with self._lock:
            table = self.embeddings[name]
        if np.size(ids) == 0:
            return np.zeros((0, table.dim), np.float32)
        rows, _found = table.get_ro(ids, default=default)
        return rows

    def to_checkpoint_payload(self):
        with self._lock:
            dense = {k: v.copy() for k, v in self.dense.items()}
            embeddings = {}
            for name, table in self.embeddings.items():
                ids, values = table.export()
                embeddings[name] = (ids, values)
            for name, table in self.slot_tables.items():
                ids, values = table.export()
                embeddings["slot:" + name] = (ids, values)
            return dense, embeddings

    def restore_from_checkpoint_payload(self, dense, embeddings, infos,
                                        slot_names=()):
        # Whole restore is one critical section (reentrant into
        # set_embedding_infos / create_slot_tables): a pull racing a
        # relaunched shard's restore must see all-or-nothing.
        with self._lock:
            for name, arr in dense.items():
                self.dense[name] = np.array(arr, np.float32, copy=True)
            self.set_embedding_infos(infos)
            for name, (ids, values) in embeddings.items():
                if name.startswith("slot:") or not len(ids):
                    continue
                if name in self.embeddings:
                    self.embeddings[name].set(ids, values)
            # Recreate optimizer slot tables, then restore their saved
            # rows — a relaunched shard must resume Adam/Momentum
            # state, not crash on the first sparse push.
            self.create_slot_tables(slot_names)
            for name, (ids, values) in embeddings.items():
                if not name.startswith("slot:") or not len(ids):
                    continue
                key = name[len("slot:"):]
                if key not in self.slot_tables:
                    self.slot_tables[key] = NativeEmbeddingTable(
                        values.shape[1], "zeros"
                    )
                self.slot_tables[key].set(ids, values)
            self.initialized = bool(self.dense) or bool(self.embeddings)
