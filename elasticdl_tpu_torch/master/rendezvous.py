"""Elastic collective membership — rendezvous epochs.

Replacement for the master-hosted Horovod rendezvous
(elasticdl/python/master/rendezvous_server.py:34-167; counterpart of
``elasticdl_tpu/master/rendezvous.py``).  Membership changes are modeled
as *epochs*: any join/leave bumps ``rendezvous_id``, and workers
observing a new id tear down their collective world (a
``torch.distributed`` process group, ``parallel/distributed.py``) and
re-form it for the new world.  Joins are batched behind a short grace
window so a burst of relaunched workers triggers one re-form, not many.
"""

import threading
import time

from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class RendezvousServer:
    def __init__(self, grace_secs=2.0, coordinator_factory=None,
                 journal=None, initial_epoch=0, name=""):
        """``coordinator_factory(world_size) -> addr`` (optional): run
        at every epoch commit to stand up that epoch's coordination
        plane — in production ``MasterCoordinationService.start_epoch``
        (parallel/distributed.py), which keeps the epoch's rendezvous
        store on the MASTER so worker churn can never strand the
        survivors.  Without a factory the address set via
        ``set_coordinator_addr`` is advertised unchanged (legacy:
        worker 0 hosts the service).

        ``journal``/``initial_epoch`` (master/journal.py): every epoch
        commit is made durable BEFORE it is published (staged under
        the lock, journaled outside it, only then visible to
        ``get_comm_rank``), so a restarted master's ``initial_epoch =
        journaled_id + 1`` is strictly above any id a surviving
        worker can hold.  Reconnecting workers see rank=-1 against
        the empty committed world, re-announce LOOP_START (the
        controller announces on rank=-1 even when the id looks
        unchanged — defense in depth should the journal tail ever be
        lost to more than a crash), and re-form at the first
        post-restart commit."""
        # ``name``: log/trace label — under the multi-tenant scheduler
        # every job owns its own rendezvous epoch space, and interleaved
        # multi-job logs must name whose epoch committed.
        self._name = name
        self._lock = threading.Lock()
        self._grace_secs = grace_secs
        self._coordinator_factory = coordinator_factory
        self._journal = journal
        self._cur_hosts = []     # committed world, sorted by join order
        self._next_hosts = []    # pending world
        self._rendezvous_id = int(initial_epoch)
        self._last_change = None
        self._coordinator_addr = ""
        # True while a staged commit is being made durable (journal
        # write outside the lock); blocks a second concurrent stage
        # from minting a colliding id.
        self._commit_inflight = False

    def set_coordinator_addr(self, addr):
        with self._lock:
            self._coordinator_addr = addr

    @property
    def rendezvous_id(self):
        with self._lock:
            return self._rendezvous_id

    @property
    def world(self):
        with self._lock:
            return list(self._cur_hosts)

    def add_worker(self, host):
        with self._lock:
            if host not in self._next_hosts:
                self._next_hosts.append(host)
                self._last_change = time.time()
                logger.info("rendezvous: worker %s joining", host)

    def remove_worker(self, host):
        with self._lock:
            if host in self._next_hosts:
                self._next_hosts.remove(host)
                self._last_change = time.time()
                logger.info("rendezvous: worker %s leaving", host)

    def _maybe_stage_commit_locked(self):
        """Stage a pending membership change WITHOUT publishing it:
        returns ``{"hosts", "n", "addr"}`` for the caller to journal
        (file I/O, outside the lock — EL006) and then publish, or
        None.  While one stage is in flight no second commit can be
        minted, so ids never collide."""
        if self._commit_inflight:
            return None
        if (
            self._next_hosts != self._cur_hosts
            and self._last_change is not None
            and time.time() - self._last_change >= self._grace_secs
        ):
            new_hosts = list(self._next_hosts)
            addr = self._coordinator_addr
            if self._coordinator_factory is not None:
                # Stand the epoch's coordination plane up BEFORE
                # publishing the epoch: a factory failure (port grabbed
                # between probe and bind, resource exhaustion) must not
                # commit a new rendezvous_id pointing at the previous
                # epoch's address.  Deferring re-arms the grace window,
                # so the commit retries.
                try:
                    addr = self._coordinator_factory(len(new_hosts))
                except Exception as e:  # noqa: BLE001
                    logger.warning(
                        "coordinator factory failed (%s); deferring "
                        "epoch commit", e,
                    )
                    self._last_change = time.time()
                    return None
            self._commit_inflight = True
            return {
                "hosts": new_hosts, "n": self._rendezvous_id + 1,
                "addr": addr,
            }
        return None

    def get_comm_rank(self, host):
        """Return (rank, world_size, rendezvous_id, coordinator_addr).

        rank == -1 means the host is not (yet) in the committed world and
        should keep polling.
        """
        with self._lock:
            staged = self._maybe_stage_commit_locked()
        if staged is not None:
            # Durable BEFORE visible: no worker may observe an epoch
            # id the journal could lose.  The flush is synchronous and
            # deliberate — commits are rare (one per membership
            # change, behind a grace window) — and because nothing is
            # published until the record is on disk, a restarted
            # master's ``initial_epoch = journaled + 1`` is strictly
            # above every id any worker can hold, however many
            # commits were in flight at the crash.  Concurrent pollers
            # meanwhile see the previous epoch and simply poll again.
            if self._journal is not None:
                try:
                    self._journal.append(
                        {"ev": "rdzv", "n": staged["n"],
                         "hosts": list(staged["hosts"])}
                    )
                    self._journal.flush()
                except Exception:
                    # Un-stage so a later poll can retry the commit;
                    # nothing was published, so no worker saw the id.
                    with self._lock:
                        self._commit_inflight = False
                    raise
            with self._lock:
                self._cur_hosts = staged["hosts"]
                self._rendezvous_id = staged["n"]
                self._coordinator_addr = staged["addr"]
                self._commit_inflight = False
                logger.info(
                    "rendezvous%s epoch %d: world=%s coordinator=%s",
                    " [%s]" % self._name if self._name else "",
                    self._rendezvous_id, self._cur_hosts,
                    self._coordinator_addr,
                )
            # Epoch commits run inside a worker's get_comm_rank server
            # span, so the re-form lands in the polling worker's trace.
            attrs = {"epoch": staged["n"],
                     "world_size": len(staged["hosts"])}
            if self._name:
                attrs["job"] = self._name
            tracing.event("rendezvous.epoch", **attrs)
        with self._lock:
            if host in self._cur_hosts:
                rank = self._cur_hosts.index(host)
            else:
                rank = -1
            return (
                rank,
                len(self._cur_hosts),
                self._rendezvous_id,
                self._coordinator_addr,
            )
