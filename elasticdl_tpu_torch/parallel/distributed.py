"""Elastic collective bootstrap, master-coordinated (counterpart of
``elasticdl_tpu/parallel/distributed.py``).

The reference's AllReduce path rebuilds a Horovod/Gloo ring from the
master-hosted rendezvous (SURVEY §2.12); a worker failure surfaces
in-band as an error from the failed collective and the survivors
re-rendezvous.  Here the ring is a ``torch.distributed`` world:

 - The MASTER hosts one ``torch.distributed.TCPStore`` per rendezvous
   epoch (``MasterCoordinationService``), on a free port, advertised as
   ``tcpstore://host:port`` through ``RendezvousServer(
   coordinator_factory=...)``.  Workers are store clients only, so a
   dying worker never takes the rendezvous plane down with it, and an
   epoch's keys never meet another epoch's.
 - Re-forming the world is ``initialize_from_rendezvous``: it destroys
   the previous world (the default group and every group a mesh built
   on it), then joins the new epoch's world with
   ``init_process_group(BACKEND, store=..., rank=..., world_size=...,
   timeout=...)``.  The timeout is explicit and bounded
   (``collective_timeout_secs``): a peer that was killed closes its
   sockets and its survivors' collective raises at once; a peer that
   stopped (SIGSTOP, a hang) surfaces when the timeout runs out, never
   after torch's 30-minute default.
 - Two epochs can commit within one discovery window, so a member may
   reach an epoch whose other members went straight on to the next.
   Members count themselves in on the epoch's store before the group
   forms, and the master marks a store superseded when it starts the
   next one: a member waiting for an old world raises ``StaleEpoch`` at
   once, and the controller looks again.
 - Unlike JAX's, torch's device tensors survive a re-formed group, so
   nothing has to be pulled to the host first.

The backend is gloo, named here only (``BACKEND``): the ranks of a job
on one machine share its card, NCCL refuses two ranks on one device,
and ``parallel/transport.py`` stages CUDA tensors through host memory on
a gloo group.  NCCL waits for a machine with a card per rank.

Single-process worlds skip distributed init entirely, so the same code
path runs in tests and single-worker jobs.  Not ported: the reference's
bare ``host:port`` address (worker 0 hosting the service) and the
``elastic_mesh_builder`` axes other than dp (ROADMAP A4c).
"""

import datetime
import gc
import os
import sys
import threading
import time
import traceback

import torch.distributed as dist

from elasticdl_tpu_torch.parallel.mesh import data_mesh
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

STORE_PREFIX = "tcpstore://"
BACKEND = "gloo"
# Keys of an epoch's store besides the group's own: members count
# themselves in, and the master names the epoch that superseded it.
_JOINED_KEY = "elasticdl/joined"
_SUPERSEDED_KEY = "elasticdl/superseded"


class StaleEpoch(RuntimeError):
    """The epoch's world cannot form: the master committed a newer one
    before every member arrived (a member that polled later went straight
    to it)."""


def _heartbeat_secs():
    """Peer-death detection latency knob (the reference's name)."""
    return int(os.environ.get("ELASTICDL_COLLECTIVE_HEARTBEAT", "10"))


# Mirrors api/controller.py DEFAULT_SECS_TO_CHECK_RENDEZVOUS (not
# imported: this module must stay importable without the api package).
_DEFAULT_CHECK_SECS = 20.0


def derive_reap_secs(check_steps=None, check_secs=None,
                     step_secs_bound=None, margin=None):
    """Old-epoch store lifetime derived from the workers' epoch-discovery
    cadence: a survivor notices a new epoch only when its controller
    polls the rendezvous, every ``check_steps`` steps (bounded by
    ``step_secs_bound`` seconds a step, env ``ELASTICDL_STEP_SECS_BOUND``)
    or every ``check_secs`` seconds; the margin is two heartbeats."""
    if step_secs_bound is None:
        step_secs_bound = float(os.environ.get(
            "ELASTICDL_STEP_SECS_BOUND", "5.0"))
    if margin is None:
        margin = 2.0 * _heartbeat_secs()
    cadence = 0.0
    if check_steps:
        cadence = max(cadence, check_steps * step_secs_bound)
    if check_secs:
        cadence = max(cadence, float(check_secs))
    if not cadence:
        cadence = _DEFAULT_CHECK_SECS
    return cadence + margin


def collective_timeout_secs(check_steps=None):
    """How long a rank waits for its peers in the group's rendezvous and
    in each collective.  Members of an epoch run the same step sequence
    and look for a new epoch at the same step, so a live peer is at most
    one check cadence behind (a joiner waits for the members' next
    check): the same bound as ``derive_reap_secs``."""
    return derive_reap_secs(check_steps=check_steps)


class MasterCoordinationService:
    """Master-side rendezvous stores, one ``TCPStore`` per epoch.

    ``start_epoch(world_size)`` starts a store server on a free port and
    returns its ``tcpstore://host:port`` address.  The PREVIOUS epoch's
    store is released on a timer after ``reap_secs`` (the reference's
    reap-on-delay contract): a survivor that has not yet noticed the new
    epoch may still be setting up or tearing down against it.
    ``reap_secs=None`` derives the delay from the check cadence
    (``derive_reap_secs``; master/main.py passes the job's
    ``check_steps``)."""

    def __init__(self, host="localhost", reap_secs=None):
        self._host = host
        self._reap_secs = (derive_reap_secs() if reap_secs is None
                           else reap_secs)
        self._store = None
        self._reapers = []

    def start_epoch(self, world_size):
        previous = self._store
        if previous is not None:
            # Members still waiting for the old world stop waiting.
            previous.set(_SUPERSEDED_KEY, str(world_size))
            reaper = threading.Timer(self._reap_secs, self._release,
                                     args=(previous,))
            reaper.daemon = True
            reaper.start()
            # A long-lived master churns through many epochs: drop
            # fired timers (each pins its old store until it fires).
            self._reapers = [r for r in self._reapers if r.is_alive()]
            self._reapers.append(reaper)
            self._store = None
        if world_size <= 0:
            return ""
        # Port 0: the server binds a free port itself (no probe race).
        store = dist.TCPStore(
            "0.0.0.0", 0, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=self._reap_secs))
        self._store = store
        addr = "%s%s:%d" % (STORE_PREFIX, self._host, store.port)
        logger.info("rendezvous store for world=%d at %s", world_size, addr)
        return addr

    @staticmethod
    def _release(store):
        del store   # the timer's reference was the last one

    def stop(self):
        for reaper in self._reapers:
            reaper.cancel()
        self._reapers = []
        self._store = None


def _timeout(timeout_secs):
    return datetime.timedelta(seconds=(
        collective_timeout_secs() if timeout_secs is None else timeout_secs))


def _leave_world():
    """Destroy the current world (the default group and every group made
    on it), if any.  A world whose peer died tears down without waiting
    for it.  A gloo group's sockets close only when its last reference
    goes (neither ``shutdown`` nor ``abort`` closes them): the trainer
    lets go of its mesh first (``CollectiveTrainer.snapshot_to_host``),
    so a peer still blocked in one of its collectives fails at once
    instead of at the timeout."""
    if dist.is_initialized():
        # Re-forming after an in-band failure runs inside its handler:
        # the failed collective's frames (finished, kept by the
        # traceback) hold the old groups too.  Clear their locals, so the
        # groups close here and the other survivors' collectives fail.
        failure = sys.exc_info()[2]
        if failure is not None:
            traceback.clear_frames(failure)
        dist.destroy_process_group()
        gc.collect()
        return True
    return False


def reset_single_process():
    """Leave any collective world and restore single-process mode (the
    last survivor, a world-1 epoch, or an idle worker stepping out of
    the world while it waits for tasks)."""
    if _leave_world():
        logger.info("collective world left: single-process mode restored")


def _await_members(store, world_size, timeout_secs, poll_secs=0.05):
    """Count this member in and wait until all ``world_size`` have
    arrived; raise ``StaleEpoch`` as soon as the master marks the epoch
    superseded, ``TimeoutError`` after ``timeout_secs``."""
    store.add(_JOINED_KEY, 1)
    deadline = time.monotonic() + timeout_secs
    while store.add(_JOINED_KEY, 0) < world_size:
        if store.check([_SUPERSEDED_KEY]):
            raise StaleEpoch("a newer epoch was committed before the world "
                             "of %d formed" % world_size)
        if time.monotonic() > deadline:
            raise TimeoutError("%d of %d members arrived within %.0f s" % (
                store.add(_JOINED_KEY, 0), world_size, timeout_secs))
        time.sleep(poll_secs)


def initialize_from_rendezvous(rank, world_size, coordinator_addr,
                               timeout_secs=None):
    """(Re-)form the ``torch.distributed`` world of a membership epoch;
    returns True when this process is in a world of more than one rank.

    Every call first destroys the previous world, so repeated calls with
    different worlds are the elastic path.  ``world_size <= 1`` leaves
    the world and returns False.  ``coordinator_addr`` is the epoch's
    ``tcpstore://host:port`` (``MasterCoordinationService``);
    ``timeout_secs`` bounds the group's rendezvous and every collective
    (None: ``collective_timeout_secs()``)."""
    if world_size <= 1 or not coordinator_addr:
        reset_single_process()
        return False
    if not coordinator_addr.startswith(STORE_PREFIX):
        raise ValueError(
            "coordinator address %r is not a master-hosted store (%shost:"
            "port)" % (coordinator_addr, STORE_PREFIX))
    host, port = coordinator_addr[len(STORE_PREFIX):].rsplit(":", 1)
    timeout = _timeout(timeout_secs)
    _leave_world()
    store = dist.TCPStore(host, int(port), is_master=False,
                          wait_for_workers=False, timeout=timeout)
    _await_members(store, world_size, timeout.total_seconds())
    dist.init_process_group(BACKEND, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    logger.info("collective world joined: rank %d / %d via %s",
                rank, world_size, coordinator_addr)
    return True


def data_mesh_builder(device=None, timeout_secs=None):
    """A ``mesh_builder(rank, world_size, coordinator_addr)`` for
    ``ElasticCollectiveController``: re-form the epoch's world, then
    build the pure data-parallel mesh over it (None in a world of one:
    the trainer runs alone).  ``device`` is this rank's."""

    def build(rank, world_size, coordinator_addr):
        if not initialize_from_rendezvous(rank, world_size,
                                          coordinator_addr, timeout_secs):
            return None
        return data_mesh(backend=BACKEND, device=device,
                         timeout=_timeout(timeout_secs))

    return build
