"""PS-backed shared embedding service for the serving tier.

The closing move of the train->serve loop (ROADMAP item 4, "Elastic
Model Aggregation with Parameter Service" in PAPERS.md): a DeepFM-class
model's embedding tables can exceed one server's RAM, so instead of
exporting the table into every servable, serving-time ``:lookup`` (and
sparse-feature resolution) rides a :class:`PSClient` straight against
the SAME sharded PS that trains the model — tables serve from where
they live, and checkpoint-cadence exports only need to publish the
dense trunk.

Two properties make this safe on the serving path:

 - **Read-mostly fencing** (docs/ps_recovery.md): every pull is issued
   ``read_only`` — absent ids come back as zero rows and are never
   lazily initialized, so serving traffic (arbitrary ids from the
   internet) cannot grow the training table — and every response is
   stamped with the shard's restart generation, so this embedding-only
   client learns about a PS crash-restore rollback from the lookups
   themselves and invalidates rows read from the dead incarnation.
 - **Outage riding**: the client is armed with the shared
   ``ps_rpc_policy`` retry budget (utils/retry.py), so a SIGKILLed
   shard's relaunch window is ridden on the same port instead of
   failing lookups (the PR-8 worker idiom, applied to serving).

In front of the PS sits a per-model :class:`HotRowCache` — an LRU of
individual embedding rows, budgeted in BYTES (the unit operators
provision), keyed by ``(model version, PS generation epoch)`` so a
fleet hot-swap or a PS restart invalidates it wholesale.  Hot ids (the
head of the usual zipfian access distribution) then serve at memory
speed while the long tail pays one PS round trip.
"""

import threading
import time
from collections import OrderedDict

import numpy as np

from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.timing import Timing

logger = get_logger(__name__)


class HotRowCache:
    """Byte-budgeted LRU of ``(table, id) -> row`` with wholesale
    version-key invalidation.

    All dict surgery runs under the cache lock; the lock is never held
    across anything blocking (the PS pull happens in the caller,
    between ``get_many`` and ``put_many``).  Counters live in the
    provided ``Timing`` (``emb_cache.hits`` / ``.misses`` /
    ``.evicted_rows`` / ``.invalidations``) so /statz and /metrics
    render them like every other serving counter.
    """

    def __init__(self, capacity_bytes, timing=None):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.timing = timing if timing is not None else Timing()
        self._lock = threading.Lock()
        self._rows = OrderedDict()   # (table, id) -> 1-D float32 row
        self._bytes = 0
        self._version_key = None

    def _rekey_locked(self, version_key):
        """Drop everything when the (model version, generation epoch)
        key ADVANCED — a fleet hot-swap or a PS restart means cached
        rows may describe state that no longer exists.  Both key
        components are monotone, so an OLDER key (a straggler thread
        finishing a pull it started before the flip) is recognized and
        refused rather than rolling the cache back; returns whether
        ``version_key`` is the current key after the call."""
        if version_key == self._version_key:
            return True
        if self._version_key is not None and (
                version_key < self._version_key):
            return False
        if self._rows:
            self.timing.bump("emb_cache.invalidations")
            self._rows.clear()
        self._bytes = 0
        self._version_key = version_key
        return True

    def get_many(self, version_key, table, ids):
        """Return (rows, missing_positions): ``rows`` is a list with a
        1-D float32 row per hit and None per miss."""
        rows = [None] * len(ids)
        missing = []
        with self._lock:
            self._rekey_locked(version_key)
            for pos, row_id in enumerate(ids):
                row = self._rows.get((table, int(row_id)))
                if row is None:
                    missing.append(pos)
                else:
                    self._rows.move_to_end((table, int(row_id)))
                    rows[pos] = row
            self.timing.bump("emb_cache.hits",
                             len(ids) - len(missing))
            self.timing.bump("emb_cache.misses", len(missing))
        return rows, missing

    def put_many(self, version_key, table, ids, vectors):
        """Insert pulled rows; evict LRU rows past the byte budget.
        A stale ``version_key`` (another thread re-keyed mid-pull)
        inserts nothing — the pull's result is still valid for ITS
        caller, just not worth caching under a dead key."""
        if self.capacity_bytes <= 0:
            return
        with self._lock:
            if not self._rekey_locked(version_key):
                return
            for pos, row_id in enumerate(ids):
                row = np.ascontiguousarray(vectors[pos], np.float32)
                key = (table, int(row_id))
                old = self._rows.pop(key, None)
                if old is not None:
                    self._bytes -= old.nbytes
                self._rows[key] = row
                self._bytes += row.nbytes
            evicted = 0
            while self._bytes > self.capacity_bytes and self._rows:
                _, old = self._rows.popitem(last=False)
                self._bytes -= old.nbytes
                evicted += 1
            if evicted:
                self.timing.bump("emb_cache.evicted_rows", evicted)

    def stats(self):
        with self._lock:
            rows = len(self._rows)
            used = self._bytes
        counters = self.timing.counters()
        hits = counters.get("emb_cache.hits", 0)
        misses = counters.get("emb_cache.misses", 0)
        return {
            "rows": rows,
            "bytes": used,
            "capacity_bytes": self.capacity_bytes,
            "hits": hits,
            "misses": misses,
            "hit_ratio": (hits / (hits + misses)
                          if hits + misses else None),
            "evicted_rows": counters.get("emb_cache.evicted_rows", 0),
            "invalidations": counters.get(
                "emb_cache.invalidations", 0),
        }


class PSEmbeddingService:
    """Serving-time embedding lookups against the training PS shards,
    fronted by a :class:`HotRowCache`.

    One instance PER MODEL ENDPOINT (the underlying retry-armed
    PSClient is shared per process): the cache is keyed by the owning
    model's version counter, and different models' counters are
    independent — a shared cache would let model a's hot-swap wipe, or
    permanently out-key, model b's rows.  ``set_version`` is called by
    the hot-swap path so the cache key tracks the SERVING model
    version — a fleet-wide version flip invalidates every replica's
    cache at its own commit point, never mixing rows across versions.
    """

    def __init__(self, ps_client, cache_bytes=64 << 20, timing=None,
                 default=0.0, probe_interval_secs=2.0):
        self.timing = timing if timing is not None else Timing()
        self.cache = HotRowCache(cache_bytes, timing=self.timing)
        self._client = ps_client
        self._default = default
        # Freshness probe cadence: a FULLY-hot cache issues no RPCs,
        # so without this it would never learn that a PS shard
        # restarted and could serve a dead incarnation's rows forever.
        # At most every probe_interval_secs one cached id is treated
        # as a miss, so the generation stamp on its pull response
        # bounds the staleness window.
        self.probe_interval_secs = float(probe_interval_secs)
        # One service lock for the version/probe state AND the
        # service-level Timing writes: lookups run CONCURRENTLY on
        # request threads (unlike the batcher's single-writer
        # executor), so unguarded timeit/bump here would corrupt the
        # shared start/total dicts.  The cache guards its own Timing
        # keys under its own lock; the two key sets are disjoint.
        self._version_lock = threading.Lock()
        self._version = 0
        self._last_pull = 0.0

    @classmethod
    def connect(cls, ps_addrs, cache_bytes=64 << 20, wire_dtype=None,
                timing=None):
        """Build against live PS shards, retry-armed with the shared
        worker->PS outage budget (``ELASTICDL_RPC_DEADLINE_SECS``)."""
        from elasticdl_tpu_torch.utils.retry import ps_rpc_policy
        from elasticdl_tpu_torch.worker.ps_client import build_ps_client

        timing = timing if timing is not None else Timing()
        client = build_ps_client(
            ps_addrs, wire_dtype=wire_dtype,
            retry=ps_rpc_policy(timing=timing),
        )
        return cls(client, cache_bytes=cache_bytes, timing=timing)

    def set_version(self, version):
        """Serving model version bump (load / hot-swap commit): re-keys
        the cache so rows never survive across a version flip."""
        with self._version_lock:
            self._version = int(version)

    def _version_key(self):
        # generation_epoch bumps whenever a KNOWN PS shard's restart
        # generation changes (PSClient notes it from every read_only
        # lookup response) — rows cached before a crash-restore
        # rollback die with the epoch.
        with self._version_lock:
            version = self._version
        return (version, self._client.generation_epoch)

    def _probe_due(self, now):
        with self._version_lock:
            if now - self._last_pull >= self.probe_interval_secs:
                self.timing.bump("emb_cache.freshness_probes")
                return True
        return False

    def _note_pull(self, now, elapsed, repull=False):
        with self._version_lock:
            self._last_pull = max(self._last_pull, now)
            self.timing.observe("emb_cache.pull", elapsed)
            if repull:
                self.timing.bump("emb_cache.epoch_repulls")

    def lookup(self, table, ids):
        """[n] int64 ids -> [n, dim] float32 rows, cache-first.

        Unknown ids return ``default`` rows — bit-identical to the
        exported-table lookup path (loader.lookup_embedding), which is
        what lets a model serve half its tables from disk exports and
        half from the PS without clients noticing."""
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size == 0:
            # The client preserves the learned row dim on empty pulls.
            return self._client.pull_embedding_vectors(
                table, ids, read_only=True)
        vkey = self._version_key()
        rows, missing = self.cache.get_many(vkey, table, ids)
        now = time.monotonic()
        if not missing and self._probe_due(now):
            # Freshness probe: one hot id pays a PS round trip so the
            # generation stamp on the response can reveal a restart.
            rows[0] = None
            missing = [0]
        pulled = None
        if missing:
            t0 = time.monotonic()
            pulled = self._client.pull_embedding_vectors(
                table, ids[missing], read_only=True,
            )
            self._note_pull(now, time.monotonic() - t0)
            fresh_key = self._version_key()
            if fresh_key != vkey:
                # A PS shard restarted (or the model version flipped)
                # mid-pull: every CACHED hit in this batch predates the
                # flip and cannot be trusted — re-pull the whole batch
                # from the live incarnation and cache it under the
                # fresh key (the old rows died in the re-key).
                t0 = time.monotonic()
                pulled = self._client.pull_embedding_vectors(
                    table, ids, read_only=True,
                )
                self._note_pull(now, time.monotonic() - t0,
                                repull=True)
                self.cache.put_many(fresh_key, table, ids, pulled)
                return pulled
            self.cache.put_many(vkey, table, ids[missing], pulled)
        dim = None
        for row in rows:
            if row is not None:
                dim = row.shape[0]
                break
        if pulled is not None and pulled.shape[0]:
            dim = pulled.shape[1]
        if dim is None:
            dim = 0
        out = np.full((len(ids), dim), self._default, np.float32)
        for pos, row in enumerate(rows):
            if row is not None:
                out[pos] = row
        if pulled is not None:
            out[missing] = pulled
        return out

    def stats(self):
        return dict(self.cache.stats(), version_key=list(
            self._version_key()))
