"""Worker-side parameter-server client.

Parity with elasticdl/python/worker/ps_client.py:37-301: dense params route
to a PS shard by name hash, embedding ids by ``id % N``; pulls/pushes fan
out to all shards as concurrent gRPC futures; duplicate embedding ids are
merged before pushing.

``wire_dtype`` ("bfloat16") compresses every float32 tensor this client
puts on the wire — pushed gradients and pulled embedding rows — to half
the bandwidth; the PS keeps its master copies and accumulation in float32
(the codec upcasts transparently on decode).  ``wire_stats`` counts the
actual serialized bytes per direction so benchmarks and the status page
can report bytes-on-wire without a proxy.

Crash-restart recovery (docs/ps_recovery.md): with ``addrs`` + ``retry``
armed, every pull/push rides a transiently-dead shard through the shared
retry policy (utils/retry.py), rebuilding that shard's channels
generation-counted with age-gated parking — the MasterClient idiom
(docs/master_recovery.md "channel rebuild"): after a shard is SIGKILLed
its old channel can wedge (stale connect backoff, poisoned fd), so each
retry reconnects on a fresh channel; rebuilds are serialized under the
refresh lock, rate-limited, and retired channels are PARKED in an
age-gated deque instead of close()d, because close() cancels other
threads' in-flight RPCs with non-retryable CANCELLED.  Independently,
the client tracks each shard's PS restart GENERATION from every
response: pushes are stamped with the generation the worker last
observed (a dead incarnation's push is rejected server-side, never
mis-applied), and ``generation_epoch`` bumps whenever a known shard's
generation changes so the trainer can reconcile (drop in-flight
pipelined pushes, invalidate prefetched embeddings, re-pull dense state
past the version fast path).
"""

import threading
import time
import uuid
from collections import deque

import grpc
import numpy as np

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.proto.rpc import PServerStub
from elasticdl_tpu_torch.utils import grpc_utils, hashing, tensor_codec
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def build_ps_client(ps_addrs, wire_dtype=None,
                    dedicated_push_channels=False, retry=None,
                    frame_wire="auto"):
    """ps_addrs: comma-separated or list of host:port.

    ``dedicated_push_channels`` opens a second connection per shard for
    gradient pushes — required for the pipelined trainer, where a
    background push sharing the pull connection's completion queue
    convoys every foreground pull behind it.

    ``retry``: a utils.retry.RetryPolicy (e.g. ``ps_rpc_policy()``)
    arming per-shard outage riding with channel rebuild; None keeps the
    historical fail-fast behavior (the worker-level minibatch retry is
    then the only ride-out).

    ``frame_wire``: "auto" (default) negotiates the raw-frame data
    plane per shard from the ``frame_capable`` bit on legacy pull
    responses; "on" forces it (benches/tests); "off" stays on the
    TensorPB encoding everywhere."""
    if isinstance(ps_addrs, str):
        ps_addrs = [a for a in ps_addrs.split(",") if a]

    def connect():
        channels = []
        for addr in ps_addrs:
            channel = grpc_utils.build_channel(addr)
            grpc_utils.wait_for_channel_ready(channel)
            channels.append(channel)
        return channels

    return PSClient(
        connect(), wire_dtype=wire_dtype,
        push_channels=connect() if dedicated_push_channels else None,
        addrs=list(ps_addrs), retry=retry, frame_wire=frame_wire,
    )


class PSClient:
    # A parked channel may only be closed once it is older than any
    # plausible in-flight RPC on it.  The floor covers the default
    # 120 s outage budget; __init__ raises it when the armed policy's
    # deadline is env-tuned longer (ELASTICDL_RPC_DEADLINE_SECS), so a
    # still-riding thread's channel is never close()d under it.
    _RETIRE_AGE_SECS = 150.0
    # Floor between rebuilds of one shard's channels: a wedged channel
    # needs ONE fresh replacement, not one per backoff step of every
    # retrying thread.
    _REBUILD_INTERVAL_SECS = 2.0

    def __init__(self, channels, wire_dtype=None, push_channels=None,
                 addrs=None, retry=None, frame_wire="auto"):
        if push_channels is not None and len(push_channels) != len(channels):
            raise ValueError(
                "push_channels must match channels per shard (%d != %d)"
                % (len(push_channels), len(channels))
            )
        if addrs is not None and len(addrs) != len(channels):
            raise ValueError(
                "addrs must match channels per shard (%d != %d)"
                % (len(addrs), len(channels))
            )
        self._channels = list(channels)
        # Optional dedicated connections for the (possibly background)
        # gradient push, so bulk push traffic never contends with the
        # latency-sensitive pull path on one HTTP/2 connection.  With
        # no dedicated channels, _push_stubs IS _stubs (one list), so a
        # rebuild swaps both views at once.
        self._push_channels = (
            list(push_channels) if push_channels else None
        )
        self._stubs = [PServerStub(c) for c in channels]
        self._push_stubs = (
            [PServerStub(c) for c in push_channels] if push_channels
            else self._stubs
        )
        # Channel-rebuild arming (see module docstring): rebuilds are
        # per-shard generation-counted under the refresh lock; every
        # call site snapshots (stub, gen) under it and runs the RPC
        # outside.
        self._addrs = list(addrs) if addrs else None
        self._refresh_lock = threading.Lock()
        self._conn_gens = [0] * len(self._stubs)
        self._last_rebuilds = [0.0] * len(self._stubs)
        self._retired = deque()   # (channel, retired_at)
        self.num_ps = len(self._stubs)
        # Outage riding: per-shard retries with channel rebuild.  None
        # (direct test construction) = the historical fail-fast client.
        self.retry_policy = retry
        if retry is not None and retry.deadline_secs:
            self._retire_age_secs = max(
                self._RETIRE_AGE_SECS, retry.deadline_secs + 30.0
            )
        else:
            self._retire_age_secs = self._RETIRE_AGE_SECS
        if wire_dtype in ("", "float32"):
            wire_dtype = None
        if wire_dtype is not None and wire_dtype not in (
            tensor_codec.WIRE_DTYPES
        ):
            raise ValueError(
                "unsupported wire_dtype %r (have float32, %s)"
                % (wire_dtype, ", ".join(tensor_codec.WIRE_DTYPES))
            )
        self.wire_dtype = wire_dtype
        # Raw-frame data plane (docs/ps_pipeline.md "Frame wire"):
        # "auto" starts every shard on TensorPB and upgrades it when a
        # legacy pull response advertises frame_capable; "on" forces
        # frames from the first RPC; "off" never leaves TensorPB.  A
        # frame RPC answered UNIMPLEMENTED (rolling upgrade against an
        # older shard) downgrades that shard back to the legacy
        # encoding.  Per-shard plain bools: flips are idempotent and
        # GIL-atomic, so no lock.
        if frame_wire not in ("auto", "on", "off"):
            raise ValueError(
                "frame_wire must be 'auto', 'on' or 'off', got %r"
                % (frame_wire,)
            )
        self._frame_wire = frame_wire
        self._frame_ok = [frame_wire == "on"] * self.num_ps
        # Generation at which a shard refused a frame RPC: its
        # frame_capable advert is ignored until the shard restarts
        # (new generation = possibly a new binary), so a lying advert
        # can't ping-pong upgrade/UNIMPLEMENTED on every RPC.
        self._frame_refused_gen = [None] * self.num_ps
        # table name -> row dim, learned from the embedding infos this
        # client pushes; lets empty pulls keep their (0, dim) shape.
        self._emb_dims = {}
        # Per-shard PS restart generation last observed (0 = unknown),
        # and the epoch counter the trainer watches: it bumps only when
        # a KNOWN generation changes — i.e. the shard restarted under
        # us.  Noted from the step thread, the push executor, and the
        # prefetch pool concurrently, hence the lock.
        self._gen_lock = threading.Lock()
        self._shard_generations = [0] * self.num_ps
        self.generation_epoch = 0
        # Serialized payload bytes per direction AND per wire encoding
        # (frame vs pb), plus the decode-copy bytes the receiving codec
        # pays for each encoding (tensor_codec decode-copy accounting —
        # computed structurally from the very messages this client
        # builds/decodes).  Bumped from the step thread, the push
        # executor, AND the prefetch pool concurrently, so every +=
        # runs under the stats lock (these are the bench's
        # bytes-on-wire artifact — lost updates would skew it).
        self._stats_lock = threading.Lock()
        self.wire_stats = {
            "push_gradient_bytes_pb": 0,
            "push_gradient_bytes_frame": 0,
            "push_decode_copy_bytes_pb": 0,
            "push_decode_copy_bytes_frame": 0,
            "pull_dense_bytes_pb": 0,
            "pull_dense_bytes_frame": 0,
            "pull_dense_decode_copy_bytes_pb": 0,
            "pull_dense_decode_copy_bytes_frame": 0,
            "pull_embedding_bytes": 0,
        }

    def _count_bytes(self, key, n):
        with self._stats_lock:
            self.wire_stats[key] += n

    # -- restart-generation tracking ----------------------------------------

    def known_generation(self, shard):
        with self._gen_lock:
            return self._shard_generations[shard]

    def generation_snapshot(self):
        """All shards' last-observed generations, atomically.  The
        pipelined trainer captures this at SUBMIT time and passes it to
        ``push_gradients(generations=...)``: the push executes later,
        and stamping it with whatever the client knows by THEN would
        let a gradient computed against a dead incarnation's state ride
        in under the new generation once any earlier response taught
        the client about the restart."""
        with self._gen_lock:
            return list(self._shard_generations)

    def _note_generation(self, shard, generation):
        if not generation:
            return  # pre-fencing server or Empty response
        bumped = False
        with self._gen_lock:
            old = self._shard_generations[shard]
            if old != generation:
                self._shard_generations[shard] = generation
                if old:
                    self.generation_epoch += 1
                    bumped = True
        if bumped:
            logger.warning(
                "PS shard %d restarted: generation %d -> %d "
                "(reconcile pending)", shard, old, generation,
            )

    # -- frame-wire negotiation ----------------------------------------------

    def frame_shards(self):
        """Shards currently speaking the raw-frame data plane (for the
        bench/tests and the status surface)."""
        return sum(1 for ok in self._frame_ok if ok)

    def _maybe_upgrade(self, shard, res):
        """A legacy pull response advertising ``frame_capable``
        upgrades this shard's subsequent push/pull traffic to the
        frame RPCs (auto mode only).  An advert from the SAME
        incarnation that already refused a frame RPC is ignored —
        without that memory a server that advertises but doesn't
        implement (version-skewed rollout) would ping-pong every
        request through an UNIMPLEMENTED probe."""
        if res.generation != self._frame_refused_gen[shard]:
            self._frame_refused_gen[shard] = None
        if (self._frame_wire == "auto" and res.frame_capable
                and self._frame_refused_gen[shard] is None
                and not self._frame_ok[shard]):
            self._frame_ok[shard] = True
            logger.info(
                "PS shard %d advertises the frame wire; upgrading "
                "push/pull traffic to frame RPCs", shard,
            )

    def _frame_downgrade(self, shard, err):
        """UNIMPLEMENTED from a frame RPC means the shard predates the
        frame plane (rolling upgrade): drop this shard back to the
        legacy TensorPB encoding and tell the caller to re-issue.
        Anything else — including UNIMPLEMENTED under forced "on"
        mode — is a real failure the caller must surface."""
        code = err.code() if hasattr(err, "code") else None
        if (code != grpc.StatusCode.UNIMPLEMENTED
                or self._frame_wire == "on"):
            return False
        if self._frame_ok[shard]:
            self._frame_ok[shard] = False
            self._frame_refused_gen[shard] = self.known_generation(
                shard)
            logger.warning(
                "PS shard %d does not implement the frame wire; "
                "falling back to TensorPB", shard,
            )
        return True

    # -- outage riding -------------------------------------------------------

    def _refresh_stub(self, shard, method_name, state, push=False):
        """Rebuild this shard's channels and return the fresh stub
        method for the retry loop; None (no rebuild possible) when
        addrs are unknown.  ``state['gen']`` is the rebuild generation
        the caller last saw: if another thread already rebuilt past
        it, no second rebuild — adopt the fresh stub."""
        if self._addrs is None:
            return None
        with self._refresh_lock:
            now = time.monotonic()
            if (
                state["gen"] == self._conn_gens[shard]
                and now - self._last_rebuilds[shard]
                >= self._REBUILD_INTERVAL_SECS
            ):
                self._retired.append((self._channels[shard], now))
                self._channels[shard] = grpc_utils.build_channel(
                    self._addrs[shard]
                )
                self._stubs[shard] = PServerStub(self._channels[shard])
                if self._push_channels is not None:
                    self._retired.append(
                        (self._push_channels[shard], now)
                    )
                    self._push_channels[shard] = grpc_utils.build_channel(
                        self._addrs[shard]
                    )
                    self._push_stubs[shard] = PServerStub(
                        self._push_channels[shard]
                    )
                while self._retired and (
                    now - self._retired[0][1] > self._retire_age_secs
                ):
                    old, _ = self._retired.popleft()
                    try:
                        old.close()
                    except Exception:  # noqa: BLE001 — already broken
                        pass
                self._conn_gens[shard] += 1
                self._last_rebuilds[shard] = now
            state["gen"] = self._conn_gens[shard]
            stub = (
                self._push_stubs[shard] if push else self._stubs[shard]
            )
            return getattr(stub, method_name)

    def _result(self, shard, method_name, rpc_fn, request, future,
                state, push=False):
        """Collect a fan-out future, riding a transiently-dead shard:
        on a retryable failure the call is re-issued synchronously
        through the retry policy, rebuilding this shard's channels
        before each retry.  The parallelism of the fan-out only matters
        on the healthy fast path — an outage is latency-bound on the
        shard's relaunch anyway."""
        try:
            return future.result()
        except Exception as err:  # noqa: BLE001 — classified below
            if self.retry_policy is None or (
                not self.retry_policy.retryable(err)
            ):
                raise
            return self.retry_policy.call(
                rpc_fn, request,
                description="%s (PS shard %d)" % (method_name, shard),
                refresh=lambda: self._refresh_stub(
                    shard, method_name, state, push
                ),
            )

    # -- partitioning -------------------------------------------------------

    def partition_dense(self, names):
        buckets = [[] for _ in range(self.num_ps)]
        for name in names:
            buckets[hashing.string_to_id(name, self.num_ps)].append(name)
        return buckets

    # -- model init ---------------------------------------------------------

    def push_model(self, dense, embedding_infos=None, version=0):
        self._remember_dims(embedding_infos)
        buckets = self.partition_dense(dense.keys())
        pending = []
        for shard, names in enumerate(buckets):
            model = tensor_codec.model_to_pb(
                dense={n: dense[n] for n in names},
                infos=embedding_infos or [],
                version=version,
            )
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            pending.append((shard, model, stub.push_model,
                            stub.push_model.future(model), state))
        for shard, req, rpc_fn, future, state in pending:
            self._result(shard, "push_model", rpc_fn, req, future, state)

    def push_embedding_table_infos(self, infos):
        self._remember_dims(infos)
        model = tensor_codec.model_to_pb(infos=infos)
        pending = []
        for shard in range(self.num_ps):
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            pending.append((
                shard, stub.push_embedding_table_infos,
                stub.push_embedding_table_infos.future(model), state,
            ))
        for shard, rpc_fn, future, state in pending:
            self._result(shard, "push_embedding_table_infos", rpc_fn,
                         model, future, state)

    def _remember_dims(self, infos):
        for info in infos or []:
            self._emb_dims[info["name"]] = int(info["dim"])

    # -- dense --------------------------------------------------------------

    def pull_dense_parameters(self, version=-1):
        """Returns (initialized, server_version, {name: array}).

        Each shard's request carries the generation this client last
        observed for it: a restarted shard answers with the full dense
        state even when its restored version is BELOW ours (the fast
        path comparison points the wrong way after a rollback).

        A frame-upgraded shard is pulled over the raw-frame RPC (one
        blob, zero-copy decode); everyone else rides the legacy
        TensorPB response, whose ``frame_capable`` bit is how "auto"
        mode learns to upgrade the shard for NEXT time."""
        pending = []
        for shard in range(self.num_ps):
            req = pb.PullDenseParametersRequest(
                version=version,
                generation=self.known_generation(shard),
            )
            framed = self._frame_ok[shard]
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            if framed:
                rpc_fn = stub.pull_dense_parameters_frame
                future = stub.pull_dense_parameters_frame.future(req)
            else:
                rpc_fn = stub.pull_dense_parameters
                future = stub.pull_dense_parameters.future(req)
            pending.append((shard, framed, req, rpc_fn, future, state))
        dense = {}
        initialized = True
        server_version = 0
        for shard, framed, req, rpc_fn, future, state in pending:
            if framed:
                try:
                    blob = self._result(
                        shard, "pull_dense_parameters_frame", rpc_fn,
                        req, future, state,
                    )
                except Exception as err:  # noqa: BLE001 — classified
                    if not self._frame_downgrade(shard, err):
                        raise
                    # Rolling downgrade: re-issue the SAME request on
                    # the legacy RPC with a fresh stub snapshot.
                    with self._refresh_lock:
                        stub = self._stubs[shard]
                        state = {"gen": self._conn_gens[shard]}
                    rpc_fn = stub.pull_dense_parameters
                    future = stub.pull_dense_parameters.future(req)
                else:
                    header = tensor_codec.peek_frame_header(blob)
                    (shard_init, shard_version, generation,
                     shard_dense) = tensor_codec.decode_params_frame(
                        blob)
                    self._note_generation(shard, generation)
                    self._count_bytes("pull_dense_bytes_frame",
                                      len(blob))
                    self._count_bytes(
                        "pull_dense_decode_copy_bytes_frame",
                        tensor_codec.frame_decode_copy_bytes(header),
                    )
                    initialized = initialized and shard_init
                    server_version = max(server_version, shard_version)
                    dense.update(shard_dense)
                    continue
            res = self._result(shard, "pull_dense_parameters", rpc_fn,
                               req, future, state)
            self._note_generation(shard, res.generation)
            self._maybe_upgrade(shard, res)
            self._count_bytes("pull_dense_bytes_pb", res.ByteSize())
            self._count_bytes(
                "pull_dense_decode_copy_bytes_pb",
                sum(tensor_codec.pb_decode_copy_bytes(t)
                    for t in res.dense_parameters.values()),
            )
            initialized = initialized and res.initialized
            server_version = max(server_version, res.version)
            for name, t in res.dense_parameters.items():
                dense[name] = tensor_codec.pb_to_ndarray(t)
        return initialized, server_version, dense

    # -- embeddings ---------------------------------------------------------

    def pull_embedding_vectors(self, name, ids, dim=None,
                               read_only=False):
        """ids: int64 [n]; returns [n, dim] rows in input order.

        ``dim`` threads the table's row dim through for the empty-ids
        case; omitted, it falls back to the infos this client pushed.

        ``read_only`` is the serving-tier lookup mode: absent ids come
        back as zero rows and are never lazily initialized on the PS
        (docs/serving.md fleet section), and the response's generation
        stamp keeps this client's restart-generation view current even
        when it never touches the dense plane."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros(
                (0, int(dim) if dim else self._emb_dims.get(name, 0)),
                np.float32,
            )
        buckets = hashing.scatter_ids(ids, self.num_ps)
        pending = {}
        for shard, positions in buckets.items():
            req = pb.PullEmbeddingVectorsRequest(
                name=name, wire_dtype=self.wire_dtype or "",
                read_only=read_only,
            )
            # .tolist() keeps the proto extend in C instead of a
            # 300k-call python genexpr (profiled hot path).
            req.ids.extend(ids[positions].tolist())
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            pending[shard] = (
                positions, req, stub.pull_embedding_vectors,
                stub.pull_embedding_vectors.future(req), state,
            )
        out = None
        for shard, (positions, req, rpc_fn, future,
                    state) in pending.items():
            res = self._result(shard, "pull_embedding_vectors", rpc_fn,
                               req, future, state)
            # Lookup responses carry the shard's restart generation
            # (TensorPB.generation, 0 = pre-stamping server): an
            # embedding-only client — the serving hot-row cache — must
            # learn about a crash-restore rollback from the lookups
            # themselves, not only from dense pulls it never issues.
            self._note_generation(shard, res.generation)
            self._count_bytes("pull_embedding_bytes", res.ByteSize())
            rows = tensor_codec.pb_to_ndarray(res)
            if out is None:
                out = np.empty((ids.size, rows.shape[1]), np.float32)
            out[positions] = rows
        return out

    # -- gradients ----------------------------------------------------------

    def push_gradients(self, dense_grads, embedding_grads=None,
                       version=0, learning_rate=0.0, generations=None):
        """dense_grads: {name: array}; embedding_grads:
        {table: (values [n, dim], ids [n])}.  Returns (accepted,
        max_server_version).

        One-shot fan-out: each shard accepts/rejects independently, which
        is fine in async mode (every push stands alone) but not atomic in
        sync mode with num_ps > 1 — use :meth:`push_gradients_atomic` for
        sync jobs so a stale reject on one shard aborts the minibatch on
        every shard.

        Each shard's request is stamped with the PS generation this
        client last observed for it (or the caller's frozen
        ``generations`` snapshot — see :meth:`generation_snapshot`: a
        DEFERRED push must be stamped with the generation its gradients
        were computed under, not whatever is current when it finally
        executes); a shard that restarted since then rejects the push
        outright (restart fencing) and the reject response's new
        generation bumps ``generation_epoch`` so the trainer
        reconciles."""
        shard_dense, shard_emb = self._shard_gradients(
            dense_grads, embedding_grads
        )
        pending = []
        for shard in range(self.num_ps):
            if not shard_dense[shard] and not shard_emb[shard]:
                continue
            generation = (
                generations[shard] if generations is not None
                else self.known_generation(shard)
            )
            framed = self._frame_ok[shard]
            if framed:
                # One frame blob IS the gRPC message (RawFrame identity
                # codec): generation and lr ride in the frame header's
                # meta so the servicer fences before decoding.
                blob = tensor_codec.encode_grads_frame(
                    dense=shard_dense[shard],
                    embeddings=shard_emb[shard],
                    version=version,
                    learning_rate=learning_rate,
                    generation=generation,
                    wire_dtype=self.wire_dtype,
                )
                self._count_bytes("push_gradient_bytes_frame",
                                  len(blob))
                self._count_bytes(
                    "push_decode_copy_bytes_frame",
                    tensor_codec.frame_decode_copy_bytes(
                        tensor_codec.peek_frame_header(blob)),
                )
            else:
                model = tensor_codec.model_to_pb(
                    dense=shard_dense[shard],
                    embeddings=shard_emb[shard],
                    version=version,
                    wire_dtype=self.wire_dtype,
                )
                req = pb.PushGradientsRequest(
                    gradients=model, learning_rate=learning_rate,
                    generation=generation,
                )
                self._count_bytes("push_gradient_bytes_pb",
                                  req.ByteSize())
                self._count_bytes(
                    "push_decode_copy_bytes_pb",
                    tensor_codec.model_pb_decode_copy_bytes(model),
                )
            with self._refresh_lock:
                stub = self._push_stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            if framed:
                req = blob
                rpc_fn = stub.push_gradients_frame
                future = stub.push_gradients_frame.future(blob)
            else:
                rpc_fn = stub.push_gradients
                future = stub.push_gradients.future(req)
            pending.append((shard, framed, generation, req, rpc_fn,
                            future, state))
        accepted = True
        max_version = 0
        for (shard, framed, generation, req, rpc_fn, future,
             state) in pending:
            if framed:
                try:
                    res = self._result(shard, "push_gradients_frame",
                                       rpc_fn, req, future, state,
                                       push=True)
                except Exception as err:  # noqa: BLE001 — classified
                    if not self._frame_downgrade(shard, err):
                        raise
                    # Rebuild the legacy request from the still-held
                    # shard buckets, stamped with the SAME generation
                    # the frame carried — re-stamping with a fresher
                    # one would unfence a pre-restart gradient.
                    model = tensor_codec.model_to_pb(
                        dense=shard_dense[shard],
                        embeddings=shard_emb[shard],
                        version=version,
                        wire_dtype=self.wire_dtype,
                    )
                    legacy = pb.PushGradientsRequest(
                        gradients=model,
                        learning_rate=learning_rate,
                        generation=generation,
                    )
                    self._count_bytes("push_gradient_bytes_pb",
                                      legacy.ByteSize())
                    self._count_bytes(
                        "push_decode_copy_bytes_pb",
                        tensor_codec.model_pb_decode_copy_bytes(model),
                    )
                    with self._refresh_lock:
                        stub = self._push_stubs[shard]
                        state = {"gen": self._conn_gens[shard]}
                    res = self._result(
                        shard, "push_gradients", stub.push_gradients,
                        legacy, stub.push_gradients.future(legacy),
                        state, push=True,
                    )
            else:
                res = self._result(shard, "push_gradients", rpc_fn,
                                   req, future, state, push=True)
            self._note_generation(shard, res.generation)
            accepted = accepted and res.accepted
            max_version = max(max_version, res.version)
        return accepted, max_version

    def _shard_gradients(self, dense_grads, embedding_grads):
        """Route gradients to their owning shards: dense by name hash,
        embedding rows by id mod N (duplicates merged first)."""
        embedding_grads = embedding_grads or {}
        shard_dense = [dict() for _ in range(self.num_ps)]
        for name, g in dense_grads.items():
            shard_dense[hashing.string_to_id(name, self.num_ps)][name] = g
        shard_emb = [dict() for _ in range(self.num_ps)]
        for table, (values, ids) in embedding_grads.items():
            values, ids = tensor_codec.merge_indexed_slices(values, ids)
            owners = np.asarray(ids) % self.num_ps
            for shard in range(self.num_ps):
                sel = owners == shard
                if sel.any():
                    shard_emb[shard][table] = (values[sel], ids[sel])
        return shard_dense, shard_emb

    def push_gradients_atomic(self, dense_grads, embedding_grads=None,
                              version=0, learning_rate=0.0):
        """Cross-shard atomic push (sync mode): prepare on every shard,
        commit only on unanimous accept, abort everywhere otherwise.

        Every shard gets a prepare — including shards that own no
        gradient this minibatch — so sync buffers fill and version
        counters advance in lockstep instead of drifting.  Prepares are
        generation-stamped like plain pushes: a shard that died and
        relaunched mid-protocol rejects its prepare, the transaction
        aborts on EVERY shard, and nothing is half-applied."""
        txn_id = uuid.uuid4().hex
        shard_dense, shard_emb = self._shard_gradients(
            dense_grads, embedding_grads
        )
        pending = []
        for shard in range(self.num_ps):
            model = tensor_codec.model_to_pb(
                dense=shard_dense[shard],
                embeddings=shard_emb[shard],
                version=version,
                wire_dtype=self.wire_dtype,
            )
            req = pb.PrepareGradientsRequest(
                txn_id=txn_id, gradients=model,
                learning_rate=learning_rate,
                generation=self.known_generation(shard),
            )
            # 2PC stays on the TensorPB wire (docs/ps_pipeline.md
            # "Frame wire" fallback matrix).
            self._count_bytes("push_gradient_bytes_pb", req.ByteSize())
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            pending.append((shard, req, stub.prepare_gradients,
                            stub.prepare_gradients.future(req), state))
        all_accept = True
        max_version = 0
        for shard, req, rpc_fn, future, state in pending:
            res = self._result(shard, "prepare_gradients", rpc_fn, req,
                               future, state)
            self._note_generation(shard, res.generation)
            all_accept = all_accept and res.accepted
            max_version = max(max_version, res.version)
        commit_req = pb.CommitGradientsRequest(
            txn_id=txn_id, commit=all_accept
        )
        pending = []
        for shard in range(self.num_ps):
            with self._refresh_lock:
                stub = self._stubs[shard]
                state = {"gen": self._conn_gens[shard]}
            pending.append((shard, stub.commit_gradients,
                            stub.commit_gradients.future(commit_req),
                            state))
        committed = True
        for shard, rpc_fn, future, state in pending:
            res = self._result(shard, "commit_gradients", rpc_fn,
                               commit_req, future, state)
            self._note_generation(shard, res.generation)
            committed = committed and res.accepted
            max_version = max(max_version, res.version)
        # A commit that found no staged txn (TTL-evicted after a long
        # stall, or the shard died and relaunched between phases) means
        # a shard missed the minibatch: surface it as a failed push so
        # the worker re-pulls and retries — bounded double-apply on the
        # shards that did commit, never a silent half-apply.
        return all_accept and committed, max_version
