"""Elastic model-aggregation tier: trainer exports in, servables out.

The port's copy of ``elasticdl_tpu/aggregation/aggregator.py``.  It
differs in one respect: the servable's program is the port's pair of
``torch.export`` programs in one file (``serving/export.PROGRAM_FILE``,
``model.pt2``), where the reference reads and writes
``model.stablehlo``, so the program it caches, reuses and publishes is
that file (and its messages say "program" where the reference's say
"StableHLO program").  ``tests/test_torch_aggregation.py`` holds it to
the reference's tests.

The piece that closes the online-learning loop ("Elastic Model
Aggregation with Parameter Service", PAPERS.md arXiv 2204.03211): the
trainer's ``--export_steps`` hook drops checkpoint-cadence servable
versions at a SOURCE base; this tier ingests them as they land,
aggregates across asynchronous/elastic trainer epochs, and publishes
complete servable versions at a PUBLISH base on a freshness SLO — the
fleet (serving/router.py + serving/fleet.py) then rolls each published
version out behind its admission barrier.

Why aggregate at all, instead of pointing the fleet at the trainer's
exports directly:

 - **Elastic trainers export out of order.**  A re-formed world (a
   preempted worker 0 relaunching, a multi-tenant re-assignment) can
   land an export whose version is BELOW one already seen.  Ingest is
   version-monotone — the same discipline as the serving replica's
   ``commit_version`` — so a stale export can never publish a
   regression; it is counted and skipped.
 - **Asynchronous epochs are noisy.**  One export is one instant of a
   moving trajectory.  Aggregating over the last W exports (uniform
   mean, or EMA weighted toward the newest) is the classic
   online-learning smoothing: the published model changes continuously
   instead of jumping with every cadence tick.
 - **Publish cadence decouples from export cadence.**  The trainer
   exports as fast as its cadence fires; the fleet pays a prepare→
   warm→barrier→commit rollout per published version.  The publisher
   throttles to ``min_publish_interval_secs`` while the freshness SLO
   (``freshness_slo_secs``) bounds how stale the serving fleet may get
   — both observable on the router's /metrics
   (``elasticdl_agg_freshness_seconds``).

Publishing reuses the source export's program and manifest
(the program depends on the model function, not the weight values) and
writes through ``serving.export.publish_export`` — atomic tmp-dir +
fsync + rename, so the fleet coordinator's scanner never sees a torn
version.  Retention (``export_keep``) GCs old published versions but
NEVER the fleet's committed version or anything newer.

Single-threaded by design: one aggregator loop owns ingest, aggregate,
publish, and GC (aggregation/main.py drives it; the bench drives it in
process).  ``stats()`` is the only cross-thread surface and is
lock-guarded; no lock is ever held across file or HTTP IO.
"""

import collections
import json
import os
import shutil
import threading
import time

import numpy as np

from elasticdl_tpu_torch.serving.export import (
    PROGRAM_FILE,
    _npz_bytes,
    publish_export,
)
from elasticdl_tpu_torch.serving.loader import list_versions
from elasticdl_tpu_torch.utils import slo as slo_mod
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ProgramMissingError(RuntimeError):
    """A streamed ingest whose parameter tree is new to this
    aggregator arrived WITHOUT an in-band program and none
    is cached — publishing it would fail.  The ingest endpoint maps
    this to HTTP 422 so the exporter re-sends with
    ``frame_bytes(include_program=True)`` (the re-prime handshake,
    docs/serving.md "Streamed ingest")."""


def _params_key(dense):
    """Program-cache key: {name: (shape, dtype)} over the dense tree —
    the program depends on exactly this.  ONE definition:
    the streamed-ingest cache write and the publish-time lookup must
    never diverge."""
    return {
        name: (tuple(np.shape(leaf)), str(np.asarray(leaf).dtype))
        for name, leaf in dense.items()
    }


class _Ingest:
    """One ingested trainer export.

    ``export_dir`` is None for a STREAMED ingest (``ingest_frame``):
    its manifest rides on the ingest itself and the program
    arrives in-band (cached on the aggregator) instead of from
    files."""

    __slots__ = ("version", "dense", "embeddings", "export_dir",
                 "born_at", "manifest", "program")

    def __init__(self, version, dense, embeddings, export_dir,
                 born_at, manifest=None, program=None):
        self.version = version
        self.dense = dense
        self.embeddings = embeddings
        self.export_dir = export_dir
        self.born_at = born_at
        self.manifest = manifest
        self.program = program


class ModelAggregator:
    def __init__(self, source_dir, publish_dir, window=4, mode="ema",
                 ema_decay=0.5, freshness_slo_secs=10.0,
                 min_publish_interval_secs=0.0, export_keep=0,
                 model_name=""):
        if mode not in ("ema", "mean", "latest"):
            raise ValueError("unknown aggregation mode %r "
                             "(ema|mean|latest)" % (mode,))
        if not 0.0 < ema_decay < 1.0 and mode == "ema":
            raise ValueError("ema_decay must be in (0, 1)")
        self.source_dir = source_dir
        self.publish_dir = publish_dir
        self.window = max(1, int(window))
        self.mode = mode
        self.ema_decay = float(ema_decay)
        self.freshness_slo_secs = float(freshness_slo_secs)
        self.min_publish_interval_secs = float(
            min_publish_interval_secs)
        self.export_keep = int(export_keep)
        self.model_name = model_name
        self._window = collections.deque(maxlen=self.window)
        self._last_ingested = 0
        self._ingested_set = set()  # pruned to on-disk versions
        self._last_published = 0
        self._last_publish_at = None   # monotonic
        self._program = None           # cached model.stablehlo bytes
        self._program_params = None    # manifest["parameters"] it fits
        # stats() is read from other threads (the router forwards
        # freshness onto /metrics, tests poll); everything else is
        # single-threaded.  The lock guards ONLY these numbers — never
        # held across IO.
        self._stats_lock = threading.Lock()
        self._counters = collections.Counter()
        self._freshness = None
        # The aggregator body is single-threaded BY DESIGN (module
        # docstring) — the streamed-ingest HTTP endpoint
        # (aggregation/main.py IngestServer) is the one cross-thread
        # mutator, so it and the control loop serialize on this lock.
        # RLock: in-process callers driving ingest+publish from one
        # thread (tests, the bench) take it re-entrantly for free.
        self.loop_lock = threading.RLock()
        # The freshness SLO as a FIRST-CLASS rule (utils/slo.py): the
        # watchdog evaluates it on every publish — a breach emits the
        # ``slo.breach`` flight-recorder event and counts an episode;
        # the per-evaluation verdict keeps the historical
        # ``slo_misses`` counter exact (one miss per over-SLO
        # publish).  Own instance: several aggregators in one process
        # (tests) must not share rule state.
        self.watchdog = slo_mod.SloWatchdog()
        self.watchdog.add_source("freshness", self._freshness_value)
        self.watchdog.add_rule(
            "value(freshness) < %s" % self.freshness_slo_secs,
            name="agg_freshness",
            description="publish freshness (publish wall - export "
                        "birth) within the --freshness_slo_secs SLO")

    def _freshness_value(self):
        with self._stats_lock:
            return self._freshness

    # -- cross-thread surface ------------------------------------------

    def bump(self, name, n=1):
        with self._stats_lock:
            self._counters[name] += n

    def stats(self):
        # Disjoint acquisitions (never nested the _stats_lock->
        # loop_lock way): ingest_frame holds loop_lock around bump(),
        # so the reverse nesting here would be a lock-order inversion.
        with self.loop_lock:
            last_ingested = self._last_ingested
            last_published = self._last_published
            window_fill = len(self._window)
        with self._stats_lock:
            counters = dict(self._counters)
            freshness = self._freshness
        return {
            "last_ingested_version": last_ingested,
            "last_published_version": last_published,
            "window_fill": window_fill,
            "freshness_seconds": freshness,
            "freshness_slo_secs": self.freshness_slo_secs,
            "counters": counters,
        }

    # -- ingest --------------------------------------------------------

    def ingest_once(self):
        """Scan the source base; ingest every new COMPLETE version in
        order.  Returns the list of versions ingested this pass.

        Version-monotone: an export at or below the high-water mark —
        a re-formed elastic world flushing an out-of-order cadence —
        is skipped and counted (``stale_exports_skipped``), exactly
        the ``commit_version`` regression rule on the serving side, so
        a late straggler can never roll the published model back."""
        from elasticdl_tpu_torch.serving.export import load_payload

        try:
            versions = list_versions(self.source_dir)
        except OSError as e:
            logger.warning("source scan failed: %s", e)
            return []
        # The window/high-water state is shared with the streamed
        # ingest thread (IngestServer) — every touch below serializes
        # on loop_lock, re-entrantly free for the control loop that
        # already holds it.
        with self.loop_lock:
            # Bounded memory: once a version leaves the source base
            # (the trainer's own retention), it leaves this set too —
            # and the monotone high-water mark keeps a re-appearance
            # unreachable.
            self._ingested_set &= set(versions)
            stale = [v for v in versions if v <= self._last_ingested
                     and v not in self._ingested_set]
            if stale:
                # Out-of-order arrivals from a re-formed world:
                # counted ONCE (added to the set below), never
                # ingested.
                self._ingested_set.update(stale)
                self.bump("stale_exports_skipped", len(stale))
            ingested = []
            for version in versions:
                if version <= self._last_ingested:
                    continue
                export_dir = os.path.join(self.source_dir,
                                          str(version))
                with tracing.span("agg.ingest", version=version):
                    try:
                        dense, embeddings = load_payload(export_dir)
                        born_at = os.path.getmtime(
                            os.path.join(export_dir, "manifest.json"))
                    except (OSError, ValueError, KeyError) as e:
                        # A GC'd or unreadable export: skip loudly;
                        # the next trainer cadence brings a fresh one.
                        logger.warning(
                            "ingest of version %d failed: %s",
                            version, e)
                        self.bump("ingest_errors")
                        continue
                    self._window.append(_Ingest(
                        version, dense, embeddings, export_dir,
                        born_at))
                    self._last_ingested = version
                    self._ingested_set.add(version)
                    ingested.append(version)
                    self.bump("ingested")
        return ingested

    def ingest_frame(self, blob, born_at=None, require_program=False):
        """STREAMED ingest: one servable frame
        (``serving.export.servable_frame_bytes`` /
        ``ContinuousExporter.frame_bytes``) hands a trainer version to
        this aggregator with no filesystem round-trip — the binary
        wire format shared with the serving data plane
        (docs/serving.md "Wire protocol"), decoded as zero-copy
        views.  The same version-monotone rule as ``ingest_once``
        applies: a stale (re-formed-world) frame is counted and
        skipped, never ingested.  The frame's in-band program
        program (present on first export / tree change) is cached for
        publishing; a malformed frame raises
        :class:`~elasticdl_tpu_torch.utils.tensor_codec.FrameError` loudly.
        Returns the ingested version, or None when skipped.

        ``require_program=True`` (the HTTP ingest endpoint's mode)
        refuses a program-less frame whose parameter tree has no
        cached program with :class:`ProgramMissingError` AT INGEST —
        a cross-host exporter must learn it needs to re-prime NOW
        (HTTP 422), not when a later publish fails server-side.  The
        default stays lax for in-process callers that prime out of
        band."""
        from elasticdl_tpu_torch.serving.export import servable_from_frame

        dense, embeddings, manifest, program = servable_from_frame(
            blob)
        version = int(manifest.get("version", 0) or 0)
        with self.loop_lock:
            if version <= self._last_ingested:
                self.bump("stale_exports_skipped")
                return None
            if (require_program and program is None
                    and (self._program is None
                         or _params_key(dense)
                         != self._program_params)):
                self.bump("program_missing_rejected")
                raise ProgramMissingError(
                    "streamed ingest of version %d carries no "
                    "program and none is cached for this "
                    "parameter tree; re-send with "
                    "frame_bytes(include_program=True)" % version)
            with tracing.span("agg.ingest", version=version,
                              streamed=True):
                if program is not None:
                    # Cache the in-band program AT INGEST: a priming
                    # frame superseded in the window before any
                    # publish must not take the program down with it.
                    self._program = program
                    self._program_params = _params_key(dense)
                self._window.append(_Ingest(
                    version, dense, embeddings, None,
                    time.time() if born_at is None else born_at,
                    manifest=manifest, program=program))
                self._last_ingested = version
                self._ingested_set.add(version)
                self.bump("ingested")
                self.bump("ingested_frames")
        return version

    # -- aggregate -----------------------------------------------------

    def aggregated_dense(self):
        """Version-deduped weighted combine over the ingest window.

        ``ema``: weights decay^age normalized (newest heaviest) —
        publish trajectory is a smoothed copy of the trainer's.
        ``mean``: uniform over the window.  ``latest``: newest export
        verbatim (aggregation off, the comparison baseline).  Only
        float leaves combine; integer leaves (ids, counters) ride from
        the newest export.  Embeddings always ride from the newest —
        averaging sparse rows that may not exist in every export would
        fabricate values."""
        with self.loop_lock:
            if not self._window:
                raise RuntimeError("nothing ingested yet")
            newest = self._window[-1]
            if self.mode == "latest" or len(self._window) == 1:
                return dict(newest.dense)
            # Snapshot under the lock; the combine below reads only
            # the (immutable) _Ingest members.
            members = list(self._window)
        if self.mode == "ema":
            weights = [self.ema_decay ** (len(members) - 1 - i)
                       for i in range(len(members))]
        else:
            weights = [1.0] * len(members)
        total = sum(weights)
        weights = [w / total for w in weights]
        out = {}
        for name, newest_leaf in newest.dense.items():
            newest_leaf = np.asarray(newest_leaf)
            if not np.issubdtype(newest_leaf.dtype, np.floating):
                out[name] = newest_leaf
                continue
            acc = np.zeros_like(newest_leaf, dtype=np.float64)
            ok = True
            for member, w in zip(members, weights):
                leaf = member.dense.get(name)
                if leaf is None or np.shape(leaf) != newest_leaf.shape:
                    ok = False
                    break
                acc += w * np.asarray(leaf, np.float64)
            # A window member missing the leaf (a model change mid-
            # window): the newest value wins whole — never an average
            # over mismatched trees.
            out[name] = (acc.astype(newest_leaf.dtype) if ok
                         else newest_leaf)
        return out

    # -- publish -------------------------------------------------------

    def publish_due(self, now=None):
        """A new ingest is waiting and the publish throttle allows."""
        with self.loop_lock:
            if not self._window or self._last_ingested <= \
                    self._last_published:
                return False
            if self._last_publish_at is None:
                return True
            now = time.monotonic() if now is None else now
            return (now - self._last_publish_at
                    >= self.min_publish_interval_secs)

    def publish(self):
        """Write the aggregated servable as
        ``<publish_dir>/<newest ingested version>/`` (atomic).  Returns
        (version, freshness_seconds): freshness is publish wall time
        minus the newest source export's birth time — the number the
        SLO constrains and /metrics exports."""
        # Held for the whole publish: a streamed ingest landing
        # mid-publish must not rotate the window out from under the
        # aggregate (loop_lock is re-entrant for the control loop).
        with self.loop_lock:
            newest = self._window[-1]
            version = newest.version
            dst = os.path.join(self.publish_dir, str(version))
            if os.path.isfile(os.path.join(dst, "manifest.json")):
                # A restarted aggregator replaying its ingest state:
                # version already published (complete versions are
                # immutable — rewriting one would ride the non-atomic
                # swap path over a dir the fleet may have committed).
                self._last_published = version
                self._last_publish_at = time.monotonic()
                self.bump("republish_skipped")
                logger.info("version %d already published; skipped",
                            version)
                return version, max(0.0,
                                    time.time() - newest.born_at)
            with tracing.span("agg.publish", version=version,
                              window=len(self._window),
                              mode=self.mode):
                dense = self.aggregated_dense()
                program, manifest = self._program_for(newest)
                manifest = dict(
                    manifest, version=version,
                    model_name=self.model_name
                    or manifest.get("model_name", ""),
                )
                manifest["aggregation"] = {
                    "mode": self.mode,
                    "window": len(self._window),
                    "source_versions": [i.version
                                        for i in self._window],
                    "ema_decay": (self.ema_decay
                                  if self.mode == "ema" else None),
                }
                payload = dict(dense)
                for name, (ids, values) in newest.embeddings.items():
                    payload["emb_ids/" + name] = ids
                    payload["emb_vals/" + name] = np.asarray(values)
                # The aggregate is plain f32 — strip any int8 storage
                # prefix the SOURCE manifest carried (quantized
                # trainer exports decode at ingest; the published npz
                # holds full weights).
                fmt = manifest.get("format", "")
                manifest["format"] = fmt.split("+")[-1]
                manifest["quantized_int8"] = []
                publish_export(
                    os.path.join(self.publish_dir, str(version)), {
                        "model.npz": _npz_bytes(payload),
                        PROGRAM_FILE: program,
                        "manifest.json": json.dumps(
                            manifest, indent=2).encode(),
                    })
            freshness = max(0.0, time.time() - newest.born_at)
            self._last_published = version
            self._last_publish_at = time.monotonic()
            window_fill = len(self._window)
        with self._stats_lock:
            self._freshness = freshness
            self._counters["published"] += 1
        # The watchdog IS the miss detector now: evaluate once per
        # publish; a breach episode lands in the flight recorder
        # (slo.breach) and the per-evaluation verdict drives the
        # historical slo_misses counter (one per over-SLO publish).
        verdicts = self.watchdog.evaluate()
        if verdicts.get("agg_freshness", {}).get("breached_now"):
            self.bump("slo_misses")
            logger.warning(
                "publish freshness %.2fs exceeds SLO %.2fs "
                "(version %d)", freshness, self.freshness_slo_secs,
                version)
        logger.info("published aggregated version %d (window %d, "
                    "mode %s, freshness %.2fs)", version,
                    window_fill, self.mode, freshness)
        return version, freshness

    def _program_for(self, ingest):
        """(program bytes, manifest dict) for a publish — the program
        program depends on the model function and the parameter
        SHAPES/DTYPES (not the weight values), so it is read once and
        reused until the tree changes.  The cache key must carry
        shapes, not just names: a resized layer keeps its flat name
        but needs the re-traced program its own export carries.

        Streamed ingests (``export_dir`` None) carry their manifest
        in-band and their program exactly when the tree changed; a
        stream that changed the tree WITHOUT shipping a program (a
        restarted aggregator that missed the priming frame) fails
        loudly here — the exporter re-primes with
        ``frame_bytes(include_program=True)``."""
        params_key = _params_key(ingest.dense)
        # The program cache is primed from the streamed-ingest thread
        # too (ingest_frame) — serialize on the same lock.
        with self.loop_lock:
            if ingest.export_dir is None:
                manifest = dict(ingest.manifest)
                if ingest.program is not None:
                    self._program = ingest.program
                    self._program_params = params_key
                elif (self._program is None
                      or params_key != self._program_params):
                    raise RuntimeError(
                        "streamed ingest of version %d carries no "
                        "program and none is cached for "
                        "this parameter tree; re-send with "
                        "frame_bytes(include_program=True)"
                        % ingest.version)
                return self._program, manifest
            with open(os.path.join(ingest.export_dir,
                                   "manifest.json")) as f:
                manifest = json.load(f)
            if (self._program is None
                    or params_key != self._program_params):
                with open(os.path.join(ingest.export_dir,
                                       PROGRAM_FILE), "rb") as f:
                    self._program = f.read()
                self._program_params = params_key
            return self._program, manifest

    # -- retention -----------------------------------------------------

    def gc_published(self, committed_floor=None):
        """Retention over the publish base: keep the newest
        ``export_keep`` versions; NEVER remove the fleet's committed
        version or anything newer (``committed_floor``) — a canary
        rollback or a healing rejoiner must always find them.  With an
        unknown floor nothing is removed (safe default).  Also reaps
        ``.tmp-*`` staging leftovers (``list_versions`` gc).  Returns
        the versions removed."""
        if not self.export_keep or committed_floor is None:
            return []
        versions = list_versions(self.publish_dir, gc_incomplete=True)
        removable = [v for v in versions[:-self.export_keep]
                     if v < int(committed_floor)]
        for version in removable:
            shutil.rmtree(
                os.path.join(self.publish_dir, str(version)),
                ignore_errors=True)
        if removable:
            self.bump("gc_removed", len(removable))
            logger.info("retention GC removed versions %s (keep %d, "
                        "committed floor %s)", removable,
                        self.export_keep, committed_floor)
        return removable
