"""The port's elastic collective bootstrap
(elasticdl_tpu_torch/parallel/distributed.py) across real processes on
the CPU: the master-hosted store per epoch and its reap delay,
``initialize_from_rendezvous`` re-forming 2 -> 1 -> 2 worlds, and a
peer that was killed (SIGKILL), stopped (SIGSTOP) or left the world
surfacing in its survivor as an exception within the group's bounded
timeout, with the survivor's teardown not hanging.

Ranks are processes of the spawn start method (one torch thread each)
that report through a queue; every wait has a time limit and every
process is killed before a test returns.  Results are exact (sums of
small integers, ranks, world sizes); the time bounds are stated where
they are asserted.
"""

import os
import queue
import signal
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from elasticdl_tpu_torch.parallel import distributed as tdist

WAIT_S = 90.0


def _rank_main(fn, args, out):
    torch.set_num_threads(1)
    try:
        out.put((os.getpid(), True, fn(*args)))
    except BaseException as e:  # noqa: BLE001 — reported to the test
        out.put((os.getpid(), False, "%s: %s" % (type(e).__name__, e)))
        raise


class Ranks:
    """Processes running module-level functions; ``results()`` collects
    one report from each, under a time limit."""

    def __init__(self):
        self._ctx = mp.get_context("spawn")
        self.out = self._ctx.Queue()
        self.procs = []

    def start(self, fn, *args):
        p = self._ctx.Process(target=_rank_main, args=(fn, args, self.out),
                              daemon=True)
        p.start()
        self.procs.append(p)
        return p

    def results(self, n, timeout=WAIT_S):
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < n:
            try:
                pid, ok, value = self.out.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError("%d of %d ranks reported within %.0f s: "
                                     "%s" % (len(got), n, timeout, got))
            assert ok, value
            got[pid] = value
        return got

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        self.out.close()


def _all_reduce(value, group=None):
    t = torch.tensor([float(value)])
    dist.all_reduce(t, group=group)
    return float(t[0])


@pytest.fixture
def ranks():
    r = Ranks()
    try:
        yield r
    finally:
        r.stop()


def _epochs_rank(plan):
    """Walk ``plan`` [(rank, world, addr), ...]: join each epoch and
    all-reduce rank+1 in it; returns [(joined, sum or None), ...]."""
    out = []
    for rank, world, addr in plan:
        joined = tdist.initialize_from_rendezvous(rank, world, addr,
                                                  timeout_secs=30)
        assert joined == dist.is_initialized()
        out.append((joined, _all_reduce(rank + 1) if joined else None,
                    dist.get_world_size() if joined else 1))
    tdist.reset_single_process()
    return out


def test_store_per_epoch_and_reap_delay(monkeypatch):
    """Each epoch gets a store of its own on a port of its own; the
    previous one is released after ``reap_secs``, not at the commit."""
    released = []
    monkeypatch.setattr(tdist.MasterCoordinationService, "_release",
                        staticmethod(lambda store: released.append(store)))
    svc = tdist.MasterCoordinationService(host="localhost", reap_secs=0.5)
    try:
        a1 = svc.start_epoch(2)
        first = svc._store
        a2 = svc.start_epoch(1)
        assert a1.startswith(tdist.STORE_PREFIX)
        assert a2.startswith(tdist.STORE_PREFIX) and a2 != a1
        host, port = a2[len(tdist.STORE_PREFIX):].rsplit(":", 1)
        client = dist.TCPStore(host, int(port), is_master=False,
                               wait_for_workers=False)
        client.set("k", "epoch2")
        assert svc._store.get("k") == b"epoch2"
        assert not first.check(["k"])   # keys never cross epochs
        assert released == []           # not reaped at the commit
        time.sleep(1.0)
        assert released == [first]      # reaped after reap_secs
        assert svc.start_epoch(0) == ""  # an empty world has no store
    finally:
        svc.stop()


def test_initialize_from_rendezvous_reforms_2_1_2(ranks):
    """Rank 0 lives through epochs of 2, 1 and 2 ranks; its first peer
    leaves after the first, a new process joins the third.  Each world's
    all-reduce sums exactly its members."""
    # One service an epoch: every epoch's store is up from the start and
    # none is marked superseded by the next (the master marks it when it
    # commits the next, after the world has formed).
    svcs = [tdist.MasterCoordinationService(reap_secs=60) for _ in range(3)]
    e1, e2, e3 = (svc.start_epoch(n) for svc, n in zip(svcs, (2, 1, 2)))
    survivor = ranks.start(_epochs_rank, [(0, 2, e1), (0, 1, e2),
                                          (0, 2, e3)])
    leaver = ranks.start(_epochs_rank, [(1, 2, e1)])
    joiner = ranks.start(_epochs_rank, [(1, 2, e3)])
    got = ranks.results(3)
    assert got[survivor.pid] == [(True, 3.0, 2), (False, None, 1),
                                 (True, 3.0, 2)]
    assert got[leaver.pid] == [(True, 3.0, 2)]
    assert got[joiner.pid] == [(True, 3.0, 2)]
    with pytest.raises(ValueError, match="tcpstore://"):
        tdist.initialize_from_rendezvous(0, 2, "localhost:1")


def _lost_peer_rank(rank, addr, how, timeout_secs):
    """Rank 1 is lost after one all-reduce (``how``: "kill" SIGKILLs it,
    "stop" SIGSTOPs it, "leave" leaves the world through the controller's
    ``leave_world`` with a trainer on the mesh); rank 0 times its next
    all-reduce and then its teardown."""
    from elasticdl_tpu_torch.api.controller import ElasticCollectiveController
    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    mesh = tdist.data_mesh_builder("cpu", timeout_secs)(rank, 2, addr)
    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=4,
                                device="cpu", mesh=mesh)
    assert _all_reduce(1, mesh.group()) == 2.0
    del mesh    # the trainer's reference is the one a worker holds
    if rank == 1:
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if how == "stop":
            os.kill(os.getpid(), signal.SIGSTOP)
        ElasticCollectiveController(None, trainer).leave_world()
        time.sleep(3 * timeout_secs)   # alive, out of the world
        return None
    xs, ys = mnist.synthetic_data(n=4, seed=1)
    t0 = time.monotonic()
    try:
        trainer.train_minibatch(xs, ys)
        error = None
    except RuntimeError as e:
        error = str(e)
    failed_s = time.monotonic() - t0
    t0 = time.monotonic()
    trainer.snapshot_to_host()
    tdist.reset_single_process()
    teardown_s = time.monotonic() - t0
    # Alone again: training goes on without a collective.
    loss, version = trainer.train_minibatch(xs, ys)
    return error, failed_s, teardown_s, float(loss), version


@pytest.mark.parametrize("how,timeout_secs,within", [
    ("kill", 30, 10.0),    # sockets close at once: far inside the timeout
    ("leave", 30, 10.0),   # the leaver's groups close with its world
    ("stop", 4, 4 + 10.0),  # a stopped peer: at the bounded timeout
])
def test_lost_peer_raises_in_the_survivor(ranks, how, timeout_secs, within):
    svc = tdist.MasterCoordinationService(reap_secs=60)
    try:
        addr = svc.start_epoch(2)
        survivor = ranks.start(_lost_peer_rank, 0, addr, how, timeout_secs)
        lost = ranks.start(_lost_peer_rank, 1, addr, how, timeout_secs)
        got = ranks.results(1, timeout=WAIT_S)
    finally:
        svc.stop()
    error, failed_s, teardown_s, loss, version = got[survivor.pid]
    assert error is not None, "the step succeeded without its peer"
    assert failed_s < within, (failed_s, error)
    if how == "stop":
        assert failed_s >= timeout_secs - 1, failed_s
        lost.kill()     # SIGKILL ends a stopped process
    assert teardown_s < 10.0, teardown_s
    assert loss == loss and version == 1   # the step after it, alone


def test_single_process_world_skips_init():
    assert not tdist.initialize_from_rendezvous(0, 1, "tcpstore://x:1")
    assert not tdist.initialize_from_rendezvous(0, 2, "")
    assert not dist.is_initialized()
    builder = tdist.data_mesh_builder("cpu")
    assert builder(0, 1, "") is None


def test_reaper_timers_are_pruned(monkeypatch):
    """A long-lived master churns through epochs: fired reap timers are
    dropped, and stop() cancels the pending ones."""
    monkeypatch.setattr(tdist.MasterCoordinationService, "_release",
                        staticmethod(lambda store: None))
    svc = tdist.MasterCoordinationService(reap_secs=0.05)
    for _ in range(4):
        svc.start_epoch(1)
        time.sleep(0.1)
    assert len(svc._reapers) <= 1
    svc.start_epoch(1)
    pending = list(svc._reapers)
    svc.stop()
    assert svc._reapers == [] and svc._store is None
    assert pending and all(r.finished.is_set() for r in pending)


def _stale_rank(addr):
    t0 = time.monotonic()
    try:
        tdist.initialize_from_rendezvous(0, 2, addr, timeout_secs=60)
    except tdist.StaleEpoch as e:
        return str(e), time.monotonic() - t0, dist.is_initialized()
    return None, time.monotonic() - t0, dist.is_initialized()


def test_member_of_a_superseded_epoch_stops_waiting(ranks):
    """Two epochs committed within one discovery window: a member that
    reached the older one while its peer went on to the newer one raises
    ``StaleEpoch`` when the master starts the newer epoch, long before
    the group's 60 s timeout."""
    svc = tdist.MasterCoordinationService(reap_secs=60)
    try:
        addr = svc.start_epoch(2)
        waiting = ranks.start(_stale_rank, addr)
        time.sleep(3.0)
        svc.start_epoch(2)
        got = ranks.results(1)
    finally:
        svc.stop()
    error, waited_s, initialized = got[waiting.pid]
    assert error and "newer epoch" in error
    assert waited_s < 30.0 and not initialized
