"""Elastic collective controller (counterpart of
``elasticdl_tpu/api/controller.py``, copied; the imports, the comments on
re-forming a world and ``_build_epoch_mesh`` differ).

Parity with elasticai_api/common/base_controller.py:48-186 and
elasticai_api/pytorch/controller.py:97-203: instead of re-initializing a
Horovod ring, a rendezvous-epoch change re-forms the ``torch.distributed``
world (``parallel/distributed.py``, through the ``mesh_builder``) and
calls the trainer's ``rebuild`` over the new mesh.  The fixed-global-batch
rule is the reference's ``backward_passes_per_step`` math: per-worker
accumulation count = global_batch_num // world_size, +1 for ranks <
remainder (pytorch/controller.py:186-198).

The managed worker (``worker/worker.py``) drives it per step
(``step_check``, ``await_new_epoch``, ``leave_world``/``rejoin_world``);
``elastic_run`` wraps a loop of the caller's own, whose records come
from ``api/dataset.ElasticDataset`` (``models/mnist_torch.py`` is the
worked example).
"""

import functools
import time

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_SECS_TO_CHECK_RENDEZVOUS = 20.0


def compute_accum_steps(global_batch_num, rank, world_size):
    """Microbatch count for one worker under a fixed global batch."""
    if world_size <= 0:
        return global_batch_num
    base = global_batch_num // world_size
    remainder = global_batch_num % world_size
    return max(1, base + (1 if rank < remainder else 0))


class RendezvousManager:
    """Tracks the master's membership epoch for this worker."""

    def __init__(self, master_client):
        self._mc = master_client
        self.rendezvous_id = -1
        self.rank = -1
        self.world_size = 0
        self.coordinator_addr = ""

    def poll(self, wait=True, poll_secs=0.5, timeout=120.0):
        """Refresh (rank, world). Returns True if the epoch changed."""
        deadline = time.time() + timeout
        while True:
            res = self._mc.get_comm_rank()
            if res.rank_id >= 0 or not wait:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    "worker never entered the rendezvous world"
                )
            time.sleep(poll_secs)
        changed = res.rendezvous_id != self.rendezvous_id
        self.rendezvous_id = res.rendezvous_id
        self.rank = res.rank_id
        self.world_size = res.world_size
        self.coordinator_addr = res.coordinator_addr
        return changed


class ElasticCollectiveController:
    """Init-once, re-rendezvous-periodically, retry-on-failure loop driver.

    Usage (mirrors the reference's ``elastic_run`` pattern):

        controller = ElasticCollectiveController(mc, trainer, shard_service,
                                                 global_batch_num=8)
        elastic_train = controller.elastic_run(train_one_batch)
        with controller.scope():
            for batch in batches:
                elastic_train(batch)
    """

    def __init__(
        self,
        master_client,
        trainer,
        data_shard_service=None,
        global_batch_num=1,
        check_secs=DEFAULT_SECS_TO_CHECK_RENDEZVOUS,
        mesh_builder=None,
        max_retries=3,
        epoch_wait_secs=60.0,
        check_steps=None,
    ):
        """``check_steps``: re-check the rendezvous every N wrapped
        calls instead of every ``check_secs`` seconds.  Step-count
        cadence is the SPMD-safe choice for multi-process collectives:
        every member of an epoch enters it at the same logical point
        and runs the same step sequence, so all members observe a new
        epoch at the SAME collective index and leave the old world
        together — a wall-clock cadence lets one rank leave while a
        peer is already blocked inside a collective the leaver will
        never join."""
        self._mc = master_client
        self._trainer = trainer
        self._shard_service = data_shard_service
        self._global_batch_num = global_batch_num
        self._check_secs = check_secs
        self._mesh_builder = mesh_builder
        self._max_retries = max_retries
        self._epoch_wait_secs = epoch_wait_secs
        self._check_steps = check_steps
        self._steps_since_check = 0
        self._rendezvous = RendezvousManager(master_client)
        self._last_check = 0.0
        self._first_init_done = False

    # -- world management ---------------------------------------------------

    def _reinit_world(self):
        rdzv = self._rendezvous
        logger.info(
            "world epoch %d: rank=%d world=%d",
            rdzv.rendezvous_id, rdzv.rank, rdzv.world_size,
        )
        if hasattr(self._trainer, "snapshot_to_host"):
            # The JAX trainer must pull state to the host before its
            # backends are cleared; the port's keeps it on the card
            # (its snapshot_to_host does nothing).
            self._trainer.snapshot_to_host()
        if self._mesh_builder is not None:
            # Multi-process path: the builder re-forms the
            # torch.distributed world of the epoch (rank, world,
            # coordinator) and builds its data mesh.
            mesh = self._build_epoch_mesh()
            self._trainer.rebuild(mesh)
        accum = compute_accum_steps(
            self._global_batch_num, rdzv.rank, rdzv.world_size
        )
        if hasattr(self._trainer, "set_accum_steps"):
            self._trainer.set_accum_steps(accum)

    def _build_epoch_mesh(self):
        """The mesh of the polled epoch.  Two epochs can commit within
        one discovery window, and a member that polled later goes
        straight to the newer one: the older world then never forms and
        the builder raises (``StaleEpoch`` at once, or the group's
        timeout).  Look again and build the newest epoch instead."""
        rdzv = self._rendezvous
        for attempt in range(self._max_retries):
            try:
                return self._mesh_builder(
                    rdzv.rank, rdzv.world_size, rdzv.coordinator_addr
                )
            except Exception as e:  # noqa: BLE001 — the world never formed
                if attempt + 1 >= self._max_retries:
                    raise
                logger.warning(
                    "world of epoch %d did not form (%s); polling again",
                    rdzv.rendezvous_id, e,
                )
                rdzv.poll(wait=True, timeout=self._epoch_wait_secs)

    def init_world_if_needed(self, force=False):
        now = time.time()
        if not force:
            if self._check_steps is not None:
                if (self._first_init_done
                        and self._steps_since_check < self._check_steps):
                    return False
            elif now - self._last_check < self._check_secs:
                return False
        self._steps_since_check = 0
        self._last_check = now
        changed = self._rendezvous.poll(wait=not self._first_init_done)
        if self._rendezvous.rank < 0:
            # Mid-churn the committed world can exclude this host
            # (poll(wait=False) still reports the new epoch).  Never
            # join a world as rank -1 — and never stay in the PREVIOUS
            # epoch's world either: its members have moved on, so its
            # next collective would block until the group's timeout
            # (and the master reaps its store).  Detach to
            # single-process mode
            # and re-announce LOOP_START so the next commit re-admits
            # us (epoch bumps again -> rank >= 0 -> rebuild).
            if changed:
                self.leave_world()
            # Announce even when the id did NOT change: a master
            # restarted from its journal re-arms at journaled+1, which
            # can EQUAL the un-journaled id this worker glimpsed just
            # before the crash — same id, empty committed world,
            # rank=-1 — and with no pending member the restarted
            # master would never commit again.  LOOP_START is
            # idempotent on the master (add_worker no-ops while the
            # host is already pending), so repeating it at the check
            # cadence is safe.
            self._mc.report_train_loop_status(pb.LOOP_START)
            return False
        if changed or not self._first_init_done:
            self._reinit_world()
            self._first_init_done = True
            return True
        return False

    @property
    def world_size(self):
        return self._rendezvous.world_size

    def step_check(self, steps=1):
        """One training step's epoch check (driven mode — a managed
        Worker calls this instead of wrapping its loop in
        elastic_run): counts the step for the check_steps cadence and
        re-forms the world when the cadence says to look.  The fused
        driver passes its window length as ``steps`` (one check per
        window, counted as the window's steps BEFORE they run; with
        windows clamped to ``steps_to_check`` a check fires at most
        window-1 steps earlier than the per-step loop's — a safe bias
        for a poll that only re-forms on a real epoch change)."""
        self._steps_since_check += steps
        return self.init_world_if_needed()

    def steps_to_check(self):
        """Steps until the next check_steps epoch-check boundary (None
        when the cadence is time-based) — the fused driver's window
        clamp."""
        if self._check_steps is None:
            return None
        return max(1, self._check_steps - self._steps_since_check)

    def leave_world(self):
        """Temporarily exit the collective world (idle worker, no task
        in hand): snapshot state, destroy the process group, restore
        single-process mode.  Peers re-form without us; rejoin_world
        re-enters.  Staying in the world while idle would stall every
        peer's collectives until the group's timeout."""
        from elasticdl_tpu_torch.parallel.distributed import (
            reset_single_process,
        )

        if hasattr(self._trainer, "snapshot_to_host"):
            self._trainer.snapshot_to_host()
        reset_single_process()

    def rejoin_world(self, timeout=120.0):
        """Re-enter the committed world after leave_world (the caller
        re-announced itself via LOOP_START) and rebuild for it."""
        self._rendezvous.poll(wait=True, timeout=timeout)
        self._reinit_world()
        # This WAS the world init: without this, the next step_check
        # would re-run _reinit_world and spuriously disconnect from the
        # live epoch service mid-epoch.
        self._first_init_done = True
        self._last_check = time.time()
        self._steps_since_check = 0

    def await_new_epoch(self, timeout=60.0, poll_secs=0.5):
        """Block until the master commits a DIFFERENT epoch, then
        rebuild for it.  The recovery path after an in-band collective
        failure: the failed world is dead, so retrying before the
        master removes the lost peer and re-forms membership would
        just fail again (reference allreduce_trainer.py:77-91 —
        Horovod survivors wait on a new rendezvous).  Returns True if
        a new epoch arrived."""
        deadline = time.time() + timeout
        epoch_seen = False
        announced = False
        while time.time() < deadline:
            if self._rendezvous.poll(wait=False):
                epoch_seen = True
            # Guard on rank >= 0 (ADVICE r5 low): a new epoch can
            # commit WITHOUT this host (the master batches joins behind
            # a grace window), and _reinit_world with rank=-1 would
            # join a world as rank -1 — undefined.  Keep polling until
            # we are a member of
            # some committed epoch.
            if epoch_seen and self._rendezvous.rank >= 0:
                self._reinit_world()
                self._last_check = time.time()
                self._steps_since_check = 0
                return True
            if not announced and (
                epoch_seen or self._rendezvous.rank < 0
            ):
                # Excluded from the new world — or orphaned at an
                # UNCHANGED id by a master that restarted from its
                # journal at exactly the id we glimpsed before the
                # crash (rank=-1 against its empty committed world, so
                # no new epoch will ever commit unless we announce):
                # detach from the doomed old epoch (its store gets
                # reaped) and re-announce so the master's next commit
                # re-admits us.
                self.leave_world()
                self._mc.report_train_loop_status(pb.LOOP_START)
                announced = True
            time.sleep(poll_secs)
        return False

    # -- loop driver ----------------------------------------------------------

    def elastic_run(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            self._steps_since_check += 1
            self.init_world_if_needed()
            err = None
            for _ in range(self._max_retries):
                try:
                    result = func(*args, **kwargs)
                    if self._shard_service is not None:
                        self._shard_service.report_batch_done()
                    return result
                except Exception as e:  # noqa: BLE001 — comm failures
                    err = e
                    logger.warning(
                        "step failed (%s); re-rendezvousing and retrying", e
                    )
                    time.sleep(1.0)
                    # In a multi-process world, prefer waiting for a
                    # NEW epoch: the failed world cannot succeed until
                    # the master removes the lost peer.  Fall back to a
                    # forced re-init if none arrives (transient error,
                    # membership unchanged) — also the whole story for
                    # single-process worlds.
                    recovered = (
                        self._rendezvous.world_size > 1
                        and self.await_new_epoch(
                            timeout=self._epoch_wait_secs)
                    )
                    if not recovered:
                        self.init_world_if_needed(force=True)
            raise RuntimeError(
                "step failed after %d re-rendezvous retries"
                % self._max_retries
            ) from err

        return wrapper

    class _Scope:
        def __init__(self, mc):
            self._mc = mc

        def __enter__(self):
            self._mc.report_train_loop_status(pb.LOOP_START)
            return self

        def __exit__(self, *exc):
            self._mc.report_train_loop_status(pb.LOOP_END)
            return False

    def scope(self):
        """Joins/leaves the rendezvous world around the training loop."""
        return self._Scope(self._mc)
