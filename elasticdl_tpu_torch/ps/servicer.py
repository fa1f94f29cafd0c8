"""PServer gRPC servicer — async and sync SGD semantics.

Parity with elasticdl/python/ps/servicer.py:33-290 and
go/pkg/ps/server.go:54-253:

 - async: every gradient push applies immediately, version++ per push,
   optional staleness-modulated learning rate (1/staleness)
 - sync: buffer pushes until ``grads_to_wait``; average dense, concatenate
   sparse; reject pushes whose model version lags beyond
   ``sync_version_tolerance`` (worker re-pulls and retries the minibatch)
 - checkpoint every ``checkpoint_steps`` versions; report version to the
   master every ``evaluation_steps`` versions

Restart-generation fencing (docs/ps_recovery.md): every response on the
data plane carries this incarnation's ``generation`` (monotone across
restarts, established by ps/server.py).  A push or prepare stamped with
a DIFFERENT generation was computed against a dead incarnation's state
and is rejected outright — in async mode the version check alone would
happily mis-apply it to the restored (older-version) state as a
"future-version" gradient.  A pull whose request carries a stale
generation bypasses the ``request.version < version`` fast path, because
after a crash-restore rollback that check points the wrong way.
``generation`` is fixed for the life of the process, so fencing reads it
without the update lock.
"""

import threading
import time

import numpy as np

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import tensor_codec, tracing
from elasticdl_tpu_torch.utils.grpc_utils import rpc_error_guard
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.timing import Timing

logger = get_logger(__name__)


class PserverServicer:
    def __init__(
        self,
        parameters,
        optimizer,
        ps_id=0,
        num_ps=1,
        use_async=True,
        grads_to_wait=1,
        sync_version_tolerance=0,
        lr_staleness_modulation=False,
        checkpoint_saver=None,
        checkpoint_steps=0,
        evaluation_steps=0,
        master_client=None,
        generation=1,
    ):
        self._params = parameters
        self._opt = optimizer
        self._ps_id = ps_id
        self._num_ps = num_ps
        self._use_async = use_async
        self._grads_to_wait = grads_to_wait
        self._sync_version_tolerance = sync_version_tolerance
        self._lr_staleness_modulation = lr_staleness_modulation
        self._checkpoint_saver = checkpoint_saver
        self._checkpoint_steps = checkpoint_steps
        self._evaluation_steps = evaluation_steps
        self._master_client = master_client
        # Restart incarnation; IMMUTABLE for the life of the process
        # (bumped by ps/server.py on every start), so fencing checks
        # read it lock-free.
        self.generation = max(1, int(generation))
        # Last version verifiably on disk (this incarnation); guarded
        # by self._lock like the checkpoint path that writes it.
        self._durable_version = 0
        self._lock = threading.Lock()
        self._grad_buffer = []   # [(dense, embeddings)] awaiting sync apply
        self._staged = {}        # txn_id -> (dense, emb, lr, stage_time)
        self._staged_ttl = 60.0  # abandon prepares from dead workers
        # Observability counters (ps/server.py --status_port).  Bumps
        # happen under self._lock EXCEPT pull_embedding, which is
        # deliberately lock-free — that one counter tolerates rare
        # lost increments rather than re-serializing the hot RPC.
        self.counters = {"push_accepted": 0, "push_rejected": 0,
                         "push_gen_rejected": 0, "ps_ckpt_failed": 0,
                         "pull_dense": 0, "pull_embedding": 0,
                         "pull_embedding_ro": 0}
        # Data-plane byte accounting per wire encoding (the frame-vs-pb
        # bench artifact, surfaced as elasticdl_ps_wire_bytes{kind=} on
        # /metrics): payload bytes received/sent, plus the bytes the
        # decode path had to COPY to produce consumable ndarrays —
        # zero-copy frames alias the gRPC message, TensorPB pays a full
        # content materialization per tensor (tensor_codec decode-copy
        # accounting).  Bumped under self._lock like the counters.
        self.wire_counters = {
            "push_payload_pb": 0, "push_payload_frame": 0,
            "push_decode_copy_pb": 0, "push_decode_copy_frame": 0,
            "pull_dense_payload_pb": 0, "pull_dense_payload_frame": 0,
        }
        # Handle-time histograms for the data-plane RPCs (push/pull),
        # rendered as native Prometheus histograms on the shard's
        # /metrics (utils/prom.ps_to_prometheus).  Durations use local
        # starts + observe — these RPCs fan out on the 64-thread gRPC
        # server, so the shared timeit starts dict would corrupt.
        self.timing = Timing()

    # -- RPCs ---------------------------------------------------------------

    @rpc_error_guard
    def push_model(self, request, _context=None):
        # Under the servicer lock: slot-table creation must not overlap
        # a concurrent push's apply (init_from_model_pb is internally
        # idempotent, but the slot tables are not).
        with self._lock:
            self._params.init_from_model_pb(request)
            self._params.create_slot_tables(self._opt.slot_names)
        return pb.Empty()

    @rpc_error_guard
    def push_embedding_table_infos(self, request, _context=None):
        _, _, infos, _ = tensor_codec.pb_to_model(request)
        with self._lock:
            self._params.set_embedding_infos(infos)
            self._params.create_slot_tables(self._opt.slot_names)
        return pb.Empty()

    @rpc_error_guard
    def pull_dense_parameters(self, request, _context=None):
        t0 = time.perf_counter()
        try:
            return self._pull_dense_parameters(request)
        finally:
            self.timing.observe("ps.pull_dense",
                                time.perf_counter() - t0)

    def _pull_dense_parameters(self, request):
        res = pb.PullDenseParametersResponse()
        res.generation = self.generation
        # Advertise the raw-frame data plane: a capable client upgrades
        # this shard's push/pull traffic to the *_frame methods after
        # its first legacy pull (docs/ps_pipeline.md "Frame wire").
        res.frame_capable = True
        # A client that last observed a different incarnation gets the
        # full dense state regardless of its version: after a crash-
        # restore rollback the server's version is BELOW the client's,
        # so the fast-path comparison alone would starve it of the
        # restored state forever (0 = client has no generation yet; the
        # version check governs, as before fencing existed).
        stale_gen = bool(request.generation) and (
            request.generation != self.generation
        )
        # Serialize against in-place kernel updates so pulls never see a
        # half-applied parameter buffer.
        with self._lock:
            self.counters["pull_dense"] += 1
            res.initialized = self._params.initialized
            res.version = self._params.version
            if self._params.initialized and (
                request.version < self._params.version
                or request.version < 0
                or stale_gen
            ):
                for name, arr in self._params.get_dense().items():
                    tensor_codec.ndarray_to_pb(
                        arr, out=res.dense_parameters[name]
                    )
            self.wire_counters["pull_dense_payload_pb"] += (
                res.ByteSize()
            )
        return res

    @rpc_error_guard
    def pull_dense_parameters_frame(self, request, _context=None):
        """Frame-native dense pull (docs/ps_pipeline.md "Frame wire"):
        same request/fast-path/fencing semantics as the pb method, but
        the response is ONE params frame blob (RawFrame identity codec)
        instead of repeated per-tensor TensorPB copies.  The
        not-modified fast path is a tensorless frame whose header meta
        still carries initialized/version/generation."""
        t0 = time.perf_counter()
        try:
            return self._pull_dense_parameters_frame(request)
        finally:
            self.timing.observe("ps.pull_dense",
                                time.perf_counter() - t0)

    def _pull_dense_parameters_frame(self, request):
        stale_gen = bool(request.generation) and (
            request.generation != self.generation
        )
        with self._lock:
            self.counters["pull_dense"] += 1
            initialized = self._params.initialized
            version = self._params.version
            dense = None
            if initialized and (
                request.version < version
                or request.version < 0
                or stale_gen
            ):
                dense = self._params.get_dense()
            # Encode UNDER the lock: encode_frame reads the parameter
            # buffers (tobytes), and a concurrent in-place apply would
            # tear them — the same reason the pb path encodes under it.
            blob = tensor_codec.encode_params_frame(
                dense, version=version, initialized=initialized,
                generation=self.generation,
            )
            self.wire_counters["pull_dense_payload_frame"] += len(blob)
        return blob

    @rpc_error_guard
    def pull_embedding_vectors(self, request, _context=None):
        t0 = time.perf_counter()
        try:
            return self._pull_embedding_vectors(request)
        finally:
            self.timing.observe("ps.pull_embedding",
                                time.perf_counter() - t0)

    def _pull_embedding_vectors(self, request):
        # No servicer lock: the native table's rw-lock (kernels.cc)
        # makes each ROW read/write atomic, so embedding traffic from
        # many workers no longer serializes behind dense updates — this
        # is the RPC the 64-thread gRPC server actually fans out.
        # Guarantee is per-row, not a cross-row snapshot: a concurrent
        # push can land between rows of one pull (uninitialized ids take
        # a second lock acquisition), which async SGD tolerates by
        # design — the same per-row semantics as the reference's Go
        # table (embedding_table.go:41-58 under RWMutex).
        if request.read_only:
            # Serving-tier lookup (docs/serving.md fleet section): a
            # read-mostly client must never grow the training table, so
            # absent ids come back as zero rows instead of being lazily
            # initialized — matching the exported-table lookup's
            # ``default=0.0`` semantics bit for bit.
            self.counters["pull_embedding_ro"] += 1
            vectors = self._params.lookup_embedding_rows(
                request.name, np.asarray(request.ids, np.int64)
            )
        else:
            self.counters["pull_embedding"] += 1
            vectors = self._params.pull_embedding_vectors(
                request.name, np.asarray(request.ids, np.int64)
            )
        # The master copy stays float32; the client may ask for a
        # reduced-precision wire encoding (request.wire_dtype, e.g.
        # "bfloat16") to halve the pull bandwidth — the codec upcasts
        # transparently on decode.
        res = tensor_codec.ndarray_to_pb(
            vectors, wire_dtype=request.wire_dtype or None
        )
        # Generation stamp on the lookup response: an embedding-only
        # client (the serving hot-row cache) otherwise never learns
        # about a crash-restore rollback — this is the PR-8 fencing
        # plane extended to the read-mostly path, so version-keyed
        # caches can invalidate rows read from a dead incarnation.
        res.generation = self.generation
        return res

    def _fence(self, request_generation):
        """Restart fencing: a push/prepare stamped by another incarnation
        is rejected before any decode or apply.  ``self.generation`` is
        immutable, so the check is lock-free; the lock is taken only to
        bump the counter and read a coherent version for the response.
        Returns the reject response, or None to proceed (0 = unstamped
        legacy client: accept, the version checks govern)."""
        if not request_generation or request_generation == self.generation:
            return None
        with self._lock:
            self.counters["push_gen_rejected"] += 1
            version = self._params.version
        # In the PUSHER's trace (server span): the fence as the shard
        # saw it — a churn drill's timeline shows which worker's dead-
        # incarnation push was refused, and when.
        tracing.event("ps.push_fenced",
                      dead_generation=request_generation,
                      generation=self.generation, version=version)
        logger.warning(
            "rejecting gradients stamped by generation %d (serving "
            "generation %d): pushed by a dead incarnation's worker view",
            request_generation, self.generation,
        )
        return pb.PushGradientsResponse(
            accepted=False, version=version, generation=self.generation
        )

    @rpc_error_guard
    def push_gradients(self, request, _context=None):
        t0 = time.perf_counter()
        try:
            return self._push_gradients(request)
        finally:
            self.timing.observe("ps.push_handle",
                                time.perf_counter() - t0)

    def _push_gradients(self, request):
        fenced = self._fence(request.generation)
        if fenced is not None:
            return fenced
        dense, embeddings, _, grad_version = tensor_codec.pb_to_model(
            request.gradients
        )
        return self._handle_push(
            dense, embeddings, grad_version,
            request.learning_rate or None,
            wire=("pb", request.gradients.ByteSize(),
                  tensor_codec.model_pb_decode_copy_bytes(
                      request.gradients)),
        )

    @rpc_error_guard
    def push_gradients_frame(self, request, _context=None):
        """Frame-native gradient push (docs/ps_pipeline.md "Frame
        wire"): ``request`` IS the frame blob (RawFrame identity
        codec).  Fencing reads ``generation`` from the PEEKED header
        meta, so a push stamped by a dead incarnation is rejected
        before any payload decode; the decode itself hands back
        zero-copy views over the gRPC message bytes, fed straight into
        the same apply path as the pb method.  A malformed blob raises
        FrameError, which rpc_error_guard surfaces as a loud
        INVALID_ARGUMENT with the server intact."""
        t0 = time.perf_counter()
        try:
            header = tensor_codec.peek_frame_header(request)
            generation = tensor_codec.frame_meta(header).get(
                "generation") or 0
            if not isinstance(generation, int):
                raise tensor_codec.FrameError(
                    "meta generation %r is not an integer"
                    % (generation,))
            fenced = self._fence(generation)
            if fenced is not None:
                return fenced
            dense, embeddings, grad_version, lr = (
                tensor_codec.decode_grads_frame(request)
            )
            return self._handle_push(
                dense, embeddings, grad_version, lr or None,
                wire=("frame", len(request),
                      tensor_codec.frame_decode_copy_bytes(header)),
            )
        finally:
            self.timing.observe("ps.push_handle",
                                time.perf_counter() - t0)

    def _handle_push(self, dense, embeddings, grad_version, lr_override,
                     wire=None):
        """Decoded-gradient apply shared by the pb and frame push
        paths — one body, so the two wire encodings stay bit-identical
        in everything that matters (staleness checks, lr modulation,
        sync buffering, version/report bookkeeping).  ``wire`` is the
        (encoding, payload_bytes, decode_copy_bytes) accounting triple,
        folded into ``wire_counters`` under the lock."""
        report = None
        with self._lock:
            if wire is not None:
                encoding, payload_bytes, copy_bytes = wire
                self.wire_counters["push_payload_" + encoding] += (
                    payload_bytes
                )
                self.wire_counters["push_decode_copy_" + encoding] += (
                    copy_bytes
                )
            if self._use_async:
                lr_mult = 1.0
                if self._lr_staleness_modulation:
                    staleness = max(
                        1, self._params.version - grad_version
                    )
                    lr_mult = 1.0 / staleness
                self._apply_locked(dense, embeddings, lr_mult, lr_override)
                self._params.version += 1
                version = self._params.version
                report = self._post_update_locked()
                self.counters["push_accepted"] += 1
                res = pb.PushGradientsResponse(
                    accepted=True, version=version
                )
            elif grad_version < (
                self._params.version - self._sync_version_tolerance
            ):
                # sync mode, stale
                self.counters["push_rejected"] += 1
                res = pb.PushGradientsResponse(
                    accepted=False, version=self._params.version
                )
            else:
                self._grad_buffer.append((dense, embeddings))
                if len(self._grad_buffer) < self._grads_to_wait:
                    self.counters["push_accepted"] += 1
                    res = pb.PushGradientsResponse(
                        accepted=True, version=self._params.version
                    )
                else:
                    dense_sum, emb_cat = self._reduce_buffer_locked()
                    self._grad_buffer.clear()
                    self._apply_locked(dense_sum, emb_cat, 1.0, lr_override)
                    self._params.version += 1
                    version = self._params.version
                    report = self._post_update_locked()
                    self.counters["push_accepted"] += 1
                    res = pb.PushGradientsResponse(
                        accepted=True, version=version
                    )
        res.generation = self.generation
        self._report_version(report)
        return res

    @rpc_error_guard
    def prepare_gradients(self, request, _context=None):
        """Phase 1 of the cross-shard atomic sync push: run the staleness
        check and stage the gradients.  Nothing is applied until commit,
        so a reject on any sibling shard can abort everywhere — no shard
        ever half-applies a minibatch (reference semantics were per-shard,
        python/ps/servicer.py:168-238; this closes that gap).  A prepare
        stamped by a dead incarnation is fenced like a push, so the 2PC
        aborts cleanly on EVERY shard when one shard died mid-protocol."""
        fenced = self._fence(request.generation)
        if fenced is not None:
            return fenced
        dense, embeddings, _, grad_version = tensor_codec.pb_to_model(
            request.gradients
        )
        with self._lock:
            now = time.monotonic()
            for txn in [
                t for t, (_, _, _, ts) in self._staged.items()
                if now - ts > self._staged_ttl
            ]:
                del self._staged[txn]  # worker died between phases
            if not self._use_async and grad_version < (
                self._params.version - self._sync_version_tolerance
            ):
                self.counters["push_rejected"] += 1
                return pb.PushGradientsResponse(
                    accepted=False, version=self._params.version,
                    generation=self.generation,
                )
            self._staged[request.txn_id] = (
                dense, embeddings, request.learning_rate or None, now
            )
            return pb.PushGradientsResponse(
                accepted=True, version=self._params.version,
                generation=self.generation,
            )

    @rpc_error_guard
    def commit_gradients(self, request, _context=None):
        """Phase 2: fold the staged entry into the sync buffer (or apply
        immediately in async mode), or drop it on abort.  Commit is
        unconditional — staleness was settled at prepare, so the
        effective tolerance is ``sync_version_tolerance`` plus in-flight
        commit concurrency (bounded by the worker count)."""
        report = None
        with self._lock:
            staged = self._staged.pop(request.txn_id, None)
            if not request.commit or staged is None:
                res = pb.PushGradientsResponse(
                    accepted=False, version=self._params.version
                )
            else:
                # Counted at COMMIT, the point a 2PC push becomes real —
                # prepare-stage rejects count as push_rejected above.
                self.counters["push_accepted"] += 1
                dense, embeddings, lr_override, _ = staged
                if self._use_async:
                    self._apply_locked(dense, embeddings, 1.0, lr_override)
                    self._params.version += 1
                    report = self._post_update_locked()
                else:
                    self._grad_buffer.append((dense, embeddings))
                    if len(self._grad_buffer) >= self._grads_to_wait:
                        dense_sum, emb_cat = self._reduce_buffer_locked()
                        self._grad_buffer.clear()
                        self._apply_locked(
                            dense_sum, emb_cat, 1.0, lr_override
                        )
                        self._params.version += 1
                        report = self._post_update_locked()
                res = pb.PushGradientsResponse(
                    accepted=True, version=self._params.version
                )
        res.generation = self.generation
        self._report_version(report)
        return res

    # -- internals ----------------------------------------------------------

    @property
    def durable_version(self):
        """Last version verifiably on disk for this shard (0 = none) —
        the shard's contribution to the cross-shard commit mark."""
        with self._lock:
            return self._durable_version

    def seed_durable_version(self, version):
        """Restore-time seeding (ps/server.py _restore): the label this
        incarnation restored from IS on disk, so the first version
        report must not drag the master's commit mark to 0."""
        with self._lock:
            self._durable_version = max(self._durable_version, version)

    def _reduce_buffer_locked(self):
        """Average dense grads; concatenate sparse grads (summing happens
        per-id inside the kernels after a merge)."""
        n = len(self._grad_buffer)
        dense_sum = {}
        emb_cat = {}
        for dense, embeddings in self._grad_buffer:
            for name, g in dense.items():
                if name in dense_sum:
                    dense_sum[name] = dense_sum[name] + g
                else:
                    dense_sum[name] = np.array(g, np.float32)
            for name, (values, ids) in embeddings.items():
                if name in emb_cat:
                    pv, pi = emb_cat[name]
                    emb_cat[name] = (
                        np.concatenate([pv, values]),
                        np.concatenate([pi, ids]),
                    )
                else:
                    emb_cat[name] = (np.asarray(values), np.asarray(ids))
        for name in dense_sum:
            dense_sum[name] = dense_sum[name] / n
        merged = {
            name: tensor_codec.merge_indexed_slices(values, ids)
            for name, (values, ids) in emb_cat.items()
        }
        return dense_sum, merged

    def _apply_locked(self, dense, embeddings, lr_mult, lr_override):
        emb = {}
        for name, (values, ids) in embeddings.items():
            values, ids = tensor_codec.merge_indexed_slices(values, ids)
            emb[name] = (values, ids)
        if lr_override:
            lr_mult = lr_mult * (lr_override / self._opt.learning_rate)
        self._opt.apply_gradients(
            self._params, dense, emb, lr_multiplier=lr_mult
        )

    def checkpoint_now(self):
        """Write this shard's checkpoint at the CURRENT version, under
        the update lock — the SIGTERM path (ps/server.py
        stop(checkpoint=True)) can land while a push_gradients apply is
        mid-flight, and a torn params/slots snapshot would restore a
        state that never existed.  Returns True iff the save landed."""
        with self._lock:
            return self._checkpoint_locked()

    def _checkpoint_locked(self):
        """Body of checkpoint_now; caller holds self._lock (the
        periodic path _post_update_locked already runs under it — the lock is
        not reentrant).  A failed save is surfaced, not just logged:
        the ``ps_ckpt_failed`` counter bumps and ``_durable_version``
        stays behind, so the version reports to the master keep
        carrying the TRUE durable mark — operators (and the recovery
        drill) can see that a restore would lose more than one
        checkpoint cadence."""
        if self._checkpoint_saver is None:
            return False
        v = self._params.version
        try:
            dense, embeddings = self._params.to_checkpoint_payload()
            # Dense optimizer slot state rides along under an
            # "optslot/" prefix so a restored shard resumes
            # Adam/Momentum trajectories (the embedding slot tables
            # are already in the payload).
            for key, arr in self._opt.slots_to_payload().items():
                dense["optslot/" + key] = arr
            self._checkpoint_saver.save_shard(
                v, self._ps_id, self._num_ps,
                dense=dense, embeddings=embeddings,
            )
        except OSError as e:
            # Sibling shards GC concurrently; a lost checkpoint must
            # never fail the worker's push RPC.
            self.counters["ps_ckpt_failed"] += 1
            tracing.event("ps.checkpoint_failed", version=v,
                          error=str(e)[:200])
            logger.warning("checkpoint at v%d failed: %s", v, e)
            return False
        self._durable_version = v
        tracing.event("ps.checkpoint", version=v)
        return True

    def _post_update_locked(self):
        """Checkpoint if due; returns the (version, durable_version)
        pair to report to the master, or None.  The report itself is an
        RPC and must happen OUTSIDE self._lock — holding the update
        lock across the master's round trip would convoy every
        concurrent pull/push behind it (EL006) — so callers release
        first, then pass the returned pair to ``_report_version``.  A
        checkpoint-cadence version always reports (not only the
        evaluation cadence): that report is how the master's
        report_version plane learns the durable commit mark
        (docs/ps_recovery.md, coordinated checkpoints)."""
        v = self._params.version
        ckpt_due = (
            self._checkpoint_saver is not None
            and self._checkpoint_steps
            and v % self._checkpoint_steps == 0
        )
        if ckpt_due:
            self._checkpoint_locked()
        report_due = (
            self._evaluation_steps and v % self._evaluation_steps == 0
        )
        if self._master_client is not None and (ckpt_due or report_due):
            return v, self._durable_version
        return None

    def _report_version(self, report):
        """Master-RPC half of _post_update_locked; call UNLOCKED.

        Outage riding lives in the client's SHORT retry policy
        (ps/server.py builds the MasterClient with a few-second
        budget — this runs inline on the push path); a master gone
        past that budget is logged and skipped, never fatal."""
        if report is None:
            return
        v, durable = report
        try:
            self._master_client.report_version(
                v, ps_id=self._ps_id, generation=self.generation,
                durable_version=durable,
            )
        except Exception as e:  # noqa: BLE001 — master may be gone
            logger.warning("report_version failed: %s", e)
