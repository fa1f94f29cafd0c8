"""Parameter-server trainer, the sparse/large-embedding path (counterpart
of ``elasticdl_tpu/worker/ps_trainer.py``).

The dense parameters and the embedding tables live on the PS shards
(``ps/``); this trainer holds a copy of the dense part as the spec's
``nn.Module`` on its device.  Embedding rows are pulled on the host and
fed into the step as leaf tensors, and one autograd pass returns the
gradients of the loss with respect to the dense parameters and to those
rows: the JAX trainer's one ``jax.value_and_grad`` over (params, rows),
run eagerly on the card.

Step shape:
  1. every ``get_model_steps``: pull dense params from the PS
     (push-to-init on first contact);
  2. host: pad the batch to the static batch size (padded examples look
     up id 0 with weight 0), collect each table's ids, unique them, pull
     those rows, and pad the rows to the flat id count;
  3. device: forward, per-example loss, masked mean, backward;
  4. the gradients leave the card in ONE copy to the host, then the
     dense gradients and each table's first ``n_uniq`` row gradients
     are pushed;
  5. a rejected push (sync-mode staleness, or a shard restart) raises
     ``GradientsRejected``; the worker's minibatch retry loop re-pulls
     and retries.

Layouts: the PS holds the dense parameters under the JAX names and
layouts (a kernel ``[in, out]``), so its checkpoints are the JAX
package's format.  The trainer maps at the pull and push boundary with
the spec's ``params_from_jax`` and ``to_jax_layout``.

Overlapped hot path (``async_push_window`` > 0, async jobs): step 4's
push runs on a single-thread executor, so step N's push overlaps step
N+1's embedding pull and compute (at most ``async_push_window`` pushes
in flight); a reject surfaces on a later ``train_minibatch`` after the
pipeline drains.  ``atomic_sync`` jobs keep the strictly ordered
prepare/commit push.  ``prefetch_embeddings`` starts the NEXT batch's
embedding pulls while the current step runs.

Crash-restart recovery: the PS client tracks each shard's restart
generation; when it moves, ``_maybe_reconcile`` drops the in-flight
pushes (the restarted shard fences them), invalidates prefetched rows,
and re-pulls dense state past the local-version fast path.  A shard
relaunched with no restorable checkpoint serves uninitialized and is
re-seeded mid-run through push-to-init.
"""

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import grpc
import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import jax_name
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.pytree import tree_leaves, tree_map
from elasticdl_tpu_torch.utils.retry import RetryPolicy
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.fused_driver import PreparedBatch, StagedWindow
from elasticdl_tpu_torch.worker.trainer import Trainer

logger = get_logger(__name__)

IDS_KEY = "__ids__"

# Prefetched embedding pulls kept live at once; the worker loop runs one
# batch ahead so 2 per table is already generous — the cap only guards
# against a caller prefetching far past what it trains.
PREFETCH_CACHE_MAX = 8


class GradientsRejected(RuntimeError):
    """Sync-mode PS rejected a stale push; re-pull and retry."""


def _pad_host_batch(tree, batch_size):
    """Pad every host leaf of ``tree`` to batch_size rows with zeros;
    returns (padded, weights) as the JAX ``_pad_batch`` does."""
    n = tree_leaves(tree)[0].shape[0]
    if n > batch_size:
        raise ValueError(
            "minibatch has %d records > trainer's global batch %d"
            % (n, batch_size)
        )
    weights = np.zeros((batch_size,), dtype=np.float32)
    weights[:n] = 1.0
    if n == batch_size:
        return tree, weights

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, [(0, batch_size - n)] + [(0, 0)] * (a.ndim - 1))

    return tree_map(pad, tree), weights


class ParameterServerTrainer(Trainer):
    def __init__(
        self,
        spec,
        ps_client,
        batch_size,
        master_client=None,
        get_model_steps=1,
        rng_seed=0,
        learning_rate=0.0,
        atomic_sync=False,
        async_push_window=0,
        device=None,
    ):
        self._spec = spec
        self._ps = ps_client
        self._batch_size = batch_size
        self._mc = master_client
        self._get_model_steps = get_model_steps
        self._learning_rate = learning_rate
        # Sync jobs with num_ps > 1 need the prepare/commit push so one
        # shard's stale-reject aborts the minibatch on every shard.
        self._atomic_sync = atomic_sync
        # Max gradient pushes in flight behind the compute (0 =
        # serialized blocking push); atomic_sync keeps it strictly
        # ordered.
        self._push_window = 0 if atomic_sync else max(
            0, int(async_push_window)
        )
        self.timing = Timing(logger=logger)
        # The async push path's bounded retry: by the time an async push
        # fails its minibatch was already reported done, so the ride-out
        # must live here or the gradient is dropped.
        self._push_retry = RetryPolicy(
            name="ps_push",
            max_attempts=6,
            deadline_secs=None,
            base_delay_secs=0.1,
            max_delay_secs=3.0,
            retryable=lambda e: isinstance(e, grpc.RpcError),
            timing=self.timing,
        )
        ps_retry = getattr(ps_client, "retry_policy", None)
        if ps_retry is not None and ps_retry.timing is None:
            ps_retry.timing = self.timing

        # One push thread => pushes leave in submission order.
        self._push_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ps-push"
        )
        self._push_inflight = deque()   # futures, oldest first
        self._prefetch_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="emb-prefetch"
        )
        self._prefetched = {}   # (table, uniq-ids bytes) -> Future[rows]
        self._prefetch_active = False

        self.device = resolve_device(device)
        self.module = spec.init_fn(self.device, rng_seed)
        # (torch name, JAX name, parameter) in a fixed order: the order
        # the gradients are packed into the one device-to-host copy.
        self._params = [(name, jax_name(name), p)
                        for name, p in self.module.named_parameters()]
        self._emb_dims = {
            info["name"]: info["dim"]
            for info in spec.ps_embedding_infos
        }
        self._version = 0
        self._steps = 0
        self._push_model_to_init()
        self._seen_gen_epoch = getattr(ps_client, "generation_epoch", 0)

    # -- PS interaction -----------------------------------------------------

    def _maybe_reconcile(self):
        """PS restart reconciliation: if the client observed a shard
        generation change since we last looked, (1) wait out the
        in-flight pushes WITHOUT surfacing their rejects (the restarted
        shard fences them), (2) drop prefetched embedding rows, and (3)
        re-pull dense state unconditionally (version=-1), since the
        restored version is usually BELOW ours.  Returns True iff a
        reconcile ran."""
        epoch = getattr(self._ps, "generation_epoch", 0)
        if epoch == self._seen_gen_epoch:
            return False
        dropped = 0
        while self._push_inflight:
            future = self._push_inflight.popleft()
            try:
                accepted, _ = future.result()
            except Exception as e:  # noqa: BLE001 — dropping anyway
                logger.warning("in-flight push failed during PS "
                               "restart reconcile: %s", e)
                accepted = False
            if not accepted:
                dropped += 1
        self._prefetched.clear()
        initialized, version, dense = self._ps.pull_dense_parameters(-1)
        if not initialized:
            # The shard came back with no restorable checkpoint: re-seed
            # it from the local model (push-to-init).
            self._push_model_to_init()
        else:
            if dense:
                self._merge_dense(dense)
            self._version = version
            self._sync_gen_snapshot()
        # Re-read AFTER the pull: generations the forced pull itself
        # noted were answered by that same full response.
        self._seen_gen_epoch = getattr(self._ps, "generation_epoch", 0)
        self.timing.bump("ps_reconcile")
        tracing.event("worker.ps_reconcile", dropped_pushes=dropped,
                      version=self._version,
                      gen_epoch=self._seen_gen_epoch)
        logger.warning(
            "reconciled PS restart: %d in-flight pushes dropped, "
            "prefetch cache invalidated, dense state re-pulled at "
            "version %d", dropped, self._version,
        )
        return True

    def push_staleness(self):
        """Depth of the async push pipeline right now (0 for atomic-sync
        or serialized jobs); the worker reports it with its progress."""
        return float(len(self._push_inflight))

    def _recover_embedding_failure(self, err):
        """An embedding pull failed after the client's retries.  Probe
        the dense plane: a shard relaunched without a checkpoint serves
        uninitialized (re-seed it), a restarted one reconciles; either
        way the minibatch surfaces as rejected so the worker retries
        it.  Healthy shards: a genuine failure, raised."""
        if self._maybe_reconcile():
            raise GradientsRejected(
                "PS restarted mid-minibatch; reconciled — retry"
            ) from err
        initialized, _, _ = self._ps.pull_dense_parameters(-1)
        if not initialized:
            logger.warning(
                "embedding pull failed against an uninitialized PS "
                "(relaunch without checkpoint?); re-seeding: %s", err,
            )
            self._push_model_to_init()
            self._maybe_reconcile()
            raise GradientsRejected(
                "PS re-seeded after relaunch-without-checkpoint — retry"
            ) from err
        if self._maybe_reconcile():
            raise GradientsRejected(
                "PS restarted mid-minibatch; reconciled — retry"
            ) from err
        raise err

    def _sync_gen_snapshot(self):
        """Freeze the per-shard generations the local params were last
        synchronized under; every push is stamped with this snapshot,
        never a later one, so a gradient computed against a dead
        incarnation's state cannot pass the restart fence."""
        snap = getattr(self._ps, "generation_snapshot", None)
        self._gen_snapshot = snap() if snap is not None else None

    def _push_model_to_init(self):
        """First contact: initialize the PS shards from the local init
        (push-to-init), then adopt what they hold."""
        initialized, version, dense = self._ps.pull_dense_parameters(-1)
        if not initialized:
            self._ps.push_model(
                self.export_parameters(),
                embedding_infos=self._spec.ps_embedding_infos,
            )
            initialized, version, dense = self._ps.pull_dense_parameters(-1)
        if dense:
            self._merge_dense(dense)
        self._version = version
        self._sync_gen_snapshot()

    def _pull_dense(self):
        with self.timing.timeit("get_model"):
            initialized, version, dense = self._ps.pull_dense_parameters(
                self._version
            )
            if not initialized:
                logger.warning(
                    "PS uninitialized (restart?); re-pushing model"
                )
                self._push_model_to_init()
                return
            if dense:
                self._merge_dense(dense)
            self._version = version
            self._sync_gen_snapshot()
        # A shard restart noted by this very pull was answered with the
        # full restored state; only the prefetched rows still need
        # dropping.
        epoch = getattr(self._ps, "generation_epoch", 0)
        if epoch != self._seen_gen_epoch:
            self._prefetched.clear()
            self._seen_gen_epoch = epoch
            self.timing.bump("ps_reconcile")
            logger.warning(
                "reconciled PS restart at cadence pull: prefetch "
                "cache invalidated, dense state restored at version "
                "%d", self._version,
            )

    def _merge_dense(self, dense):
        """Copy a (possibly partial) dense pull, JAX names and layouts,
        into the module's parameters: a freshly restored shard can lag
        the others and return only its slice, or nothing at all."""
        # Writable copies: a frame-wire pull hands back read-only views.
        state = self._spec.params_from_jax(
            {name: np.array(value) for name, value in dense.items()})
        params = dict(self.module.named_parameters())
        with torch.no_grad():
            for name, value in state.items():
                param = params[name]
                param.copy_(value.reshape(param.shape).to(param.dtype))

    # -- async push pipeline ------------------------------------------------

    def _submit_push(self, named_grads, emb_push):
        """Queue the push behind the compute; once ``async_push_window``
        pushes are in flight, block on the oldest (the pipeline's
        backpressure).  The gradients are host arrays already."""
        while len(self._push_inflight) >= self._push_window:
            self.timing.bump("push_window_stall")
            self._drain_oldest_push()
        version = self._version
        learning_rate = self._learning_rate
        generations = self._gen_snapshot

        def push():
            # A retry-armed client (ps_rpc_policy) carries its own
            # outage budget per call; _push_retry wraps only the
            # fail-fast client, so the two budgets never multiply.
            if getattr(self._ps, "retry_policy", None) is not None:
                return self._ps.push_gradients(
                    named_grads, emb_push,
                    version=version, learning_rate=learning_rate,
                    generations=generations,
                )
            return self._push_retry.call(
                self._ps.push_gradients,
                named_grads, emb_push,
                version=version, learning_rate=learning_rate,
                generations=generations,
                description="async gradient push",
            )

        self._push_inflight.append(self._push_pool.submit(push))
        self.timing.bump("push_async_submitted")

    def _drain_oldest_push(self):
        future = self._push_inflight.popleft()
        with self.timing.timeit("push_drain_wait"):
            accepted, _ = future.result()
        if not accepted:
            # Empty the pipeline before surfacing the reject, so the
            # worker's retry starts from a clean state; a generation-
            # fenced reject reconciles instead of a fast-path pull.
            self.drain_pushes()
            if not self._maybe_reconcile():
                self._pull_dense()
            raise GradientsRejected(
                "stale gradients at version %d" % self._version
            )

    def drain_pushes(self):
        """Block until no gradient push is in flight (timed as
        ``push_drain``).  Rejects and RPC errors are counted and logged,
        not raised."""
        if not self._push_inflight:
            return
        with self.timing.timeit("push_drain"):
            while self._push_inflight:
                future = self._push_inflight.popleft()
                try:
                    accepted, _ = future.result()
                except Exception as e:  # noqa: BLE001 — see docstring
                    logger.warning("async gradient push failed: %s", e)
                    accepted = False
                if not accepted:
                    self.timing.bump("push_drain_dropped")

    def close(self):
        """Drain the pipeline and stop the background threads; the
        trainer stays usable for evaluation (pulls are synchronous)."""
        self.drain_pushes()
        self._prefetched.clear()
        self._push_pool.shutdown(wait=True)
        self._prefetch_pool.shutdown(wait=True)

    # -- embedding plumbing -------------------------------------------------

    def _padded_unique_ids(self, ids):
        """Pad an id array to the static batch size as the batch padding
        will (zero rows -> id 0), then unique: prefetch and prepare
        derive the SAME key for the same logical batch."""
        ids = np.asarray(ids, dtype=np.int64)
        n = ids.shape[0]
        if n < self._batch_size:
            pad = [(0, self._batch_size - n)] + [(0, 0)] * (ids.ndim - 1)
            ids = np.pad(ids, pad)
        return ids, np.unique(ids.reshape(-1))

    def prefetch_embeddings(self, features):
        """Start the NEXT batch's embedding pulls on a background pool;
        ``_prepare_embeddings`` picks the rows up by id-set key.  A no-op
        outside pipelined mode, where a prefetched row set would predate
        the current batch's push."""
        if self._push_window == 0:
            return
        if not isinstance(features, dict) or IDS_KEY not in features:
            return
        self._prefetch_active = True
        for table, ids in features[IDS_KEY].items():
            _, uniq = self._padded_unique_ids(ids)
            key = (table, uniq.tobytes())
            if key in self._prefetched:
                continue
            while len(self._prefetched) >= PREFETCH_CACHE_MAX:
                self._prefetched.pop(next(iter(self._prefetched)))
            self._prefetched[key] = self._prefetch_pool.submit(
                self._ps.pull_embedding_vectors, table, uniq,
                self._emb_dims[table],
            )

    def _prepare_embeddings(self, features):
        """Extract ids, pull rows; returns (features with ``idx__<table>``,
        {table: rows padded to the flat id count}, {table: (uniq ids,
        n_uniq)})."""
        if not isinstance(features, dict) or IDS_KEY not in features:
            return features, {}, {}
        features = dict(features)
        ids_map = features.pop(IDS_KEY)
        emb_inputs = {}
        push_info = {}
        for table, ids in ids_map.items():
            ids = np.asarray(ids, dtype=np.int64)
            flat = ids.reshape(-1)
            uniq, inverse = np.unique(flat, return_inverse=True)
            n_uniq = uniq.size
            prefetched = self._prefetched.pop(
                (table, uniq.tobytes()), None
            )
            with self.timing.timeit("pull_embedding"):
                try:
                    if prefetched is not None:
                        rows = prefetched.result()
                        self.timing.bump("prefetch_hit")
                    else:
                        rows = self._ps.pull_embedding_vectors(
                            table, uniq, dim=self._emb_dims[table]
                        )
                        if self._prefetch_active:
                            self.timing.bump("prefetch_miss")
                except grpc.RpcError as err:
                    self._recover_embedding_failure(err)
            padded_rows = np.zeros(
                (flat.size, self._emb_dims[table]), np.float32
            )
            padded_rows[:n_uniq] = rows
            features["idx__" + table] = inverse.reshape(ids.shape).astype(
                np.int32
            )
            emb_inputs[table] = padded_rows
            push_info[table] = (uniq, n_uniq)
        return features, emb_inputs, push_info

    # -- the step -----------------------------------------------------------

    def _to_device(self, tree):
        return tree_map(
            lambda a: torch.as_tensor(np.asarray(a)).to(self.device), tree)

    def _inputs(self, features, emb_inputs, requires_grad):
        """Device features with ``emb__<table>`` rows merged in; returns
        (features, [row tensors in table order])."""
        feats = self._to_device(features)
        rows = []
        for table in sorted(emb_inputs):
            t = torch.as_tensor(emb_inputs[table]).to(self.device)
            t.requires_grad_(requires_grad)
            feats["emb__" + table] = t
            rows.append(t)
        return feats, rows

    def grad_step(self, features, labels, weights, emb_inputs):
        """One forward and backward on the device over the dense
        parameters and the embedding rows (prepared host inputs);
        returns (loss, dense grads [params order], row grads [sorted
        tables]), all on the device."""
        feats, rows = self._inputs(features, emb_inputs, True)
        labels = torch.as_tensor(np.asarray(labels)).to(self.device)
        weights = torch.as_tensor(weights).to(self.device)
        out = self._spec.apply_fn(self.module, feats, True)
        per_example = self._spec.loss_fn(out, labels).float()
        per_example = per_example.reshape(per_example.shape[0], -1).mean(-1)
        loss = (per_example * weights).sum() / weights.sum().clamp(min=1.0)
        params = [p for _, _, p in self._params]
        grads = torch.autograd.grad(loss, params + rows, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(params + rows, grads)]
        return loss.detach(), grads[:len(params)], grads[len(params):]

    def _host_grads(self, dense_grads, row_grads, push_info):
        """The step's gradients in one device-to-host copy, unpacked
        into the push's host arrays: {JAX name: grad in the JAX layout}
        and {table: (the first n_uniq row grads, uniq ids)}."""
        grads = dense_grads + row_grads
        flat = torch.cat([g.reshape(-1).float() for g in grads]).cpu()
        pieces = torch.split(flat, [g.numel() for g in grads])
        named = {}
        for (_, name, p), piece in zip(self._params, pieces):
            named[name] = self._spec.to_jax_layout(piece.reshape(p.shape))
        emb_push = {}
        for table, piece in zip(sorted(push_info),
                                pieces[len(self._params):]):
            uniq_ids, n_uniq = push_info[table]
            rows = piece.reshape(-1, self._emb_dims[table]).numpy()
            emb_push[table] = (rows[:n_uniq], uniq_ids)
        return named, emb_push

    # -- Trainer API --------------------------------------------------------

    def train_minibatch(self, features, labels):
        # A PS restart noted since the last step reconciles BEFORE any
        # state from the dead incarnation is consumed.
        self._maybe_reconcile()
        if self._steps % self._get_model_steps == 0:
            # Drain first, so every dense pull observes all of this
            # worker's own pushes.
            self.drain_pushes()
            self._pull_dense()
        # Pad BEFORE preparing embeddings so id-array shapes are static
        # across partial batches (padding rows look up id 0, weight 0).
        (features, labels), weights = _pad_host_batch(
            (features, labels), self._batch_size
        )
        features, emb_inputs, push_info = self._prepare_embeddings(features)
        with self.timing.timeit("batch_process"):
            loss, dense_grads, row_grads = self.grad_step(
                features, labels, weights, emb_inputs)
            # The device-to-host copy of the gradients ends the step.
            named_grads, emb_push = self._host_grads(
                dense_grads, row_grads, push_info)
        with self.timing.timeit("report_gradient"):
            if self._push_window > 0:
                self._submit_push(named_grads, emb_push)
                accepted, version = True, self._version
            elif self._atomic_sync:
                accepted, version = self._ps.push_gradients_atomic(
                    named_grads, emb_push,
                    version=self._version,
                    learning_rate=self._learning_rate,
                )
            else:
                accepted, version = self._ps.push_gradients(
                    named_grads, emb_push,
                    version=self._version,
                    learning_rate=self._learning_rate,
                    generations=self._gen_snapshot,
                )
        if not accepted:
            if not self._maybe_reconcile():
                self._pull_dense()
            raise GradientsRejected(
                "stale gradients at version %d" % self._version
            )
        # _version means "the server version my local params correspond
        # to" and advances only in _pull_dense: the push response's newer
        # version would make the next pull's fast path skip the update.
        self._steps += 1
        return loss, version

    # -- fused window API (fused_driver.FusedStepDriver) --------------------

    @property
    def max_window(self):
        """The overlap lives in the async push pipeline and the
        embedding prefetcher, and every step may need a fresh pull, so
        the fused driver runs one step a window here."""
        return 1

    def steps_to_boundary(self):
        return None

    def prepare_batch(self, features, labels, count=None):
        """Passthrough: padding happens inside train_minibatch, after the
        id extraction that must see the raw feature dict."""
        n = tree_leaves(features)[0].shape[0]
        return PreparedBatch(
            features, labels, None, n if count is None else count
        )

    def stage_window(self, prepared, to_device=True):
        del to_device  # the step moves its own inputs
        return StagedWindow(
            len(prepared),
            [b.features for b in prepared],
            [b.labels for b in prepared],
            None,
        )

    def train_window(self, staged):
        losses = []
        version = self._version
        for features, labels in zip(staged.features, staged.labels):
            loss, version = self.train_minibatch(features, labels)
            losses.append(loss)
        return losses[0] if len(losses) == 1 else losses, version

    def evaluate_minibatch(self, features, labels):
        # Flush pending pushes so evaluation reads everything this
        # worker trained, and reconcile a noted PS restart first.
        self.drain_pushes()
        self._maybe_reconcile()
        n = tree_leaves(features)[0].shape[0]
        (features, labels), _ = _pad_host_batch(
            (features, labels), self._batch_size
        )
        features, emb_inputs, _ = self._prepare_embeddings(features)
        with torch.no_grad():
            feats, _ = self._inputs(features, emb_inputs, False)
            outputs = self._spec.apply_fn(self.module, feats, False)
        return outputs.float().cpu().numpy()[:n], np.asarray(labels)[:n]

    def predict_minibatch(self, features):
        outputs, _ = self.evaluate_minibatch(
            features,
            np.zeros((tree_leaves(features)[0].shape[0],), np.int32))
        return outputs

    @property
    def version(self):
        return self._version

    def export_parameters(self):
        """{JAX name: ndarray in the JAX layout} of the dense part."""
        return {name: self._spec.to_jax_layout(p)
                for _, name, p in self._params}
