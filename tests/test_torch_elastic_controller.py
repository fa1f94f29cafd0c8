"""The port's elastic controller (elasticdl_tpu_torch/api/controller.py)
and its rendezvous plumbing, against the port's master: the ports of
tests/test_elastic_controller.py and of the two controller cases of
tests/test_master_recovery.py that need no outage injection
(``test_rendezvous_epoch_monotonic_across_restart``,
``test_controller_reannounces_at_unchanged_restart_epoch``).

All eleven of test_elastic_controller.py's tests are here, each under
its reference name.  ``test_zero1_snapshot_falls_back_to_fresh_moments``
is the port's form of its contract: the port's trainer keeps its state on
the card across a re-formed world and gathers nothing before it, so the
shards are lost when the new world lacks one, and the moments then
restart from the parameters.

``test_first_world_waits_for_the_launched_workers`` is the port's own:
its rendezvous commits the first world once the master's launched
workers have joined.

The master is the port's in-process one (``master/master.py``, real gRPC
on a localhost port) with the port's ``RendezvousServer``; everything is
exact (epochs, ranks, counts), so no tolerance applies.
"""

import time
from types import SimpleNamespace

import pytest

from elasticdl_tpu_torch.api.controller import (
    ElasticCollectiveController,
    compute_accum_steps,
)
from elasticdl_tpu_torch.master.journal import JournalWriter, replay_journal
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.parallel import distributed as tdist
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.worker.master_client import MasterClient


def create_master(training_shards, records_per_task):
    """The port's in-process master with a rendezvous server (the
    reference's tests/test_utils.create_master(rendezvous=True))."""
    master = Master(
        TaskManager(training_shards=training_shards,
                    records_per_task=records_per_task, num_epochs=1),
        rendezvous_server=RendezvousServer(grace_secs=0.1))
    master.prepare()
    return master


def create_master_client(master, worker_id=0):
    channel = grpc_utils.build_channel("localhost:%d" % master.port)
    grpc_utils.wait_for_channel_ready(channel)
    return MasterClient(channel, worker_id=worker_id)


@pytest.fixture
def master():
    master = create_master([("f", 0, 8)], records_per_task=8)
    try:
        yield master
    finally:
        master.stop()


def test_compute_accum_steps_fixed_global_batch():
    # 8 microbatches globally over 3 workers: ranks 0,1 get 3, rank 2 gets 2
    assert compute_accum_steps(8, 0, 3) == 3
    assert compute_accum_steps(8, 1, 3) == 3
    assert compute_accum_steps(8, 2, 3) == 2
    assert compute_accum_steps(8, 0, 8) == 1
    assert compute_accum_steps(2, 5, 8) == 1  # never below 1


class FakeTrainer:
    def __init__(self):
        self.rebuilds = []
        self.accum = None

    def rebuild(self, mesh):
        self.rebuilds.append(mesh)

    def set_accum_steps(self, n):
        self.accum = n


def test_controller_reinits_on_epoch_change(master):
    mc = create_master_client(master, worker_id=0)
    trainer = FakeTrainer()
    controller = ElasticCollectiveController(
        mc, trainer, global_batch_num=8, check_secs=0.0,
        mesh_builder=lambda rank, world, coord: ("mesh", world),
    )
    calls = []

    @controller.elastic_run
    def step(x):
        calls.append(x)
        return x * 2

    with controller.scope():
        time.sleep(0.15)  # rendezvous grace
        assert step(1) == 2
        assert trainer.accum == 8  # world of 1 -> all microbatches local
        assert trainer.rebuilds == [("mesh", 1)]

        # second worker joins -> epoch bump -> rebuild with world=2
        mc2 = create_master_client(master, worker_id=1)
        mc2.report_train_loop_status(pb.LOOP_START)
        time.sleep(0.15)
        assert step(2) == 4
        assert trainer.rebuilds[-1] == ("mesh", 2)
        assert trainer.accum == 4
    assert calls == [1, 2]


def test_controller_retries_on_step_failure(master):
    mc = create_master_client(master, worker_id=0)
    controller = ElasticCollectiveController(
        mc, FakeTrainer(), global_batch_num=1, check_secs=0.0)
    state = {"fails": 2}

    @controller.elastic_run
    def flaky():
        if state["fails"] > 0:
            state["fails"] -= 1
            raise RuntimeError("collective timeout")
        return "ok"

    with controller.scope():
        time.sleep(0.15)
        assert flaky() == "ok"

    @controller.elastic_run
    def always_fails():
        raise RuntimeError("dead link")

    with pytest.raises(RuntimeError, match="re-rendezvous retries"):
        always_fails()


def test_step_check_cadence_is_step_counted(master):
    """check_steps=N: the rendezvous is polled every N wrapped calls —
    the SPMD-safe cadence (all members observe a new epoch at the same
    collective index), not wall-clock."""
    mc = create_master_client(master, worker_id=0)
    trainer = FakeTrainer()
    controller = ElasticCollectiveController(
        mc, trainer, check_steps=3,
        mesh_builder=lambda r, w, c: ("mesh", w),
    )
    with controller.scope():
        time.sleep(0.15)
        controller.step_check()  # first call: world init
        assert trainer.rebuilds == [("mesh", 1)]
        # second worker joins; cadence says: no check for 2 calls
        mc2 = create_master_client(master, worker_id=1)
        mc2.report_train_loop_status(pb.LOOP_START)
        time.sleep(0.15)
        controller.step_check()
        controller.step_check()
        assert trainer.rebuilds == [("mesh", 1)]  # not yet
        controller.step_check()  # 3rd call since check -> poll
        assert trainer.rebuilds[-1] == ("mesh", 2)


def test_await_new_epoch_times_out_without_change(master):
    mc = create_master_client(master, worker_id=0)
    controller = ElasticCollectiveController(
        mc, FakeTrainer(), check_secs=0.0)
    with controller.scope():
        time.sleep(0.15)
        controller.init_world_if_needed()
        t0 = time.monotonic()
        assert controller.await_new_epoch(timeout=0.5,
                                          poll_secs=0.05) is False
        assert time.monotonic() - t0 < 5.0


def test_leave_and_rejoin_world(master):
    """The idle-worker protocol: leave_world snapshots + exits, the
    master commits a smaller epoch; rejoin_world re-enters after
    LOOP_START and rebuilds — and the next step_check does NOT
    redundantly re-init (rejoin counts as the world init)."""
    mc = create_master_client(master, worker_id=0)

    class SnapshotTrainer(FakeTrainer):
        def __init__(self):
            super().__init__()
            self.snapshots = 0

        def snapshot_to_host(self):
            self.snapshots += 1

    trainer = SnapshotTrainer()
    controller = ElasticCollectiveController(
        mc, trainer, check_steps=1,
        mesh_builder=lambda r, w, c: ("mesh", w),
    )
    with controller.scope():
        time.sleep(0.15)
        controller.step_check()
        assert trainer.rebuilds == [("mesh", 1)]
        controller.leave_world()
        assert trainer.snapshots >= 1
        mc.report_train_loop_status(pb.LOOP_END)
        time.sleep(0.15)
        # commits are lazy (inside get_comm_rank) — poke one
        rank, size, _, _ = master.rendezvous_server.get_comm_rank(
            "worker-0")
        assert (rank, size) == (-1, 0)
        mc.report_train_loop_status(pb.LOOP_START)
        controller.rejoin_world(timeout=10)
        assert trainer.rebuilds[-1] == ("mesh", 1)
        rebuilds_after_rejoin = len(trainer.rebuilds)
        controller.step_check()  # must NOT re-init the same epoch
        assert len(trainer.rebuilds) == rebuilds_after_rejoin


def test_zero1_snapshot_falls_back_to_fresh_moments(master):
    """Parameters must survive a world change; ZeRO-1 optimizer shards
    lost with a dead peer are re-initialized from the parameters (the
    information loss a Horovod restart accepts when it reloads a
    checkpoint without slots).  The trainer holds rank 0's shards of a
    world of 2, as that world's ``rebuild`` cut them; the controller's
    re-form into the master's world of 1 (``snapshot_to_host``, then
    ``rebuild``) finds the other shard gone."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.models import mnist
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer,
    )

    trainer = CollectiveTrainer(mnist.model_spec(), batch_size=4,
                                device="cpu", zero1=True)
    xs, ys = mnist.synthetic_data(n=4)
    trainer.train_minibatch(xs, ys)  # moments become non-zero
    trainer._world_size, trainer._rank = 2, 0
    trainer._cut(layout_id=1)
    trainer._world_size = 1
    params = trainer.export_parameters()
    shards = trainer._shard_state()
    assert trainer._zero.num_shards == 2
    assert any(torch.any(v != 0) for v in shards.values()
               if isinstance(v, torch.Tensor))

    controller = ElasticCollectiveController(
        create_master_client(master), trainer, check_secs=0.0,
        mesh_builder=lambda rank, world, coord: None)
    with controller.scope():
        time.sleep(0.15)  # rendezvous grace
        assert controller.init_world_if_needed(force=True)
    assert controller.world_size == 1
    after = trainer.export_parameters()
    assert all(np.array_equal(params[k], after[k]) for k in params)
    state = trainer._whole_state()
    big = [v for v in state.values() if isinstance(v, torch.Tensor)]
    assert big and all(not torch.any(v) for v in big)
    assert trainer.timing.counters()["zero1_moment_resets"] == 1
    assert trainer._zero is None and trainer.version == 1


def test_coordinator_factory_failure_defers_commit():
    """The coordination plane is stood up BEFORE the epoch publishes:
    a factory failure (port stolen between probe and bind) must NOT
    commit a new rendezvous_id pointing at the old address — the
    commit defers, re-arms the grace window, and succeeds on retry."""
    calls = {"n": 0}

    def flaky_factory(world_size):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("address in use")
        return "%slocalhost:%d" % (tdist.STORE_PREFIX, 40000 + world_size)

    rdzv = RendezvousServer(grace_secs=0.05,
                            coordinator_factory=flaky_factory)
    rdzv.add_worker("w0")
    time.sleep(0.06)
    rank, size, epoch, addr = rdzv.get_comm_rank("w0")  # factory fails
    assert (rank, size, epoch, addr) == (-1, 0, 0, "")
    time.sleep(0.06)  # grace re-armed; retry succeeds
    rank, size, epoch, addr = rdzv.get_comm_rank("w0")
    assert (rank, size, epoch) == (0, 1, 1)
    assert addr == "tcpstore://localhost:40001"
    assert calls["n"] == 2


class _ScriptedMC:
    """Master client returning a scripted get_comm_rank sequence (the
    last entry repeats)."""

    def __init__(self, responses):
        self._responses = list(responses)
        self.loop_statuses = []

    def get_comm_rank(self):
        res = SimpleNamespace()
        (res.rendezvous_id, res.rank_id, res.world_size,
         res.coordinator_addr) = (
            self._responses.pop(0) if len(self._responses) > 1
            else self._responses[0]
        )
        return res

    def report_train_loop_status(self, status):
        self.loop_statuses.append(status)


def test_await_new_epoch_never_reinits_as_nonmember():
    """A new epoch can commit WITHOUT this host (grace window batching);
    await_new_epoch must keep polling until rank >= 0 instead of joining
    a world as rank -1."""
    mc = _ScriptedMC([
        (2, -1, 2, "tcpstore://x:1"),  # epoch changed, we're not in it
        (2, -1, 2, "tcpstore://x:1"),
        (3, 1, 3, "tcpstore://x:2"),   # next epoch admits us
    ])
    trainer = FakeTrainer()
    built = []
    controller = ElasticCollectiveController(
        mc, trainer, global_batch_num=3,
        mesh_builder=lambda r, w, c: built.append((r, w)) or ("m", w),
    )
    controller._rendezvous.rendezvous_id = 1  # was a member of epoch 1
    controller._rendezvous.rank = 0
    assert controller.await_new_epoch(timeout=5.0, poll_secs=0.01)
    assert built == [(1, 3)], built  # never called with rank=-1
    assert trainer.rebuilds == [("m", 3)]


def test_step_check_skips_reinit_while_excluded():
    """The cadence path has the same guard: an epoch that excludes this
    host must not trigger _reinit_world (rank=-1) — it must DETACH and
    re-announce LOOP_START so the master re-admits us."""
    mc = _ScriptedMC([
        (1, 0, 1, ""),                 # first init: world of 1
        (2, -1, 2, "tcpstore://x:1"),  # bumped epoch excludes us
        (3, 0, 3, "tcpstore://x:2"),   # re-admitted
    ])
    trainer = FakeTrainer()
    built = []
    controller = ElasticCollectiveController(
        mc, trainer, check_steps=1,
        mesh_builder=lambda r, w, c: built.append((r, w)) or ("m", w),
    )
    controller.step_check()          # init at world 1
    controller.step_check()          # excluded epoch: detach, no rebuild
    assert built == [(0, 1)], built  # no rebuild with rank=-1
    assert mc.loop_statuses == [pb.LOOP_START]  # re-announced ourselves
    controller.step_check()          # re-admitted: rebuild now
    assert built == [(0, 1), (0, 3)], built


def test_derive_reap_secs_tracks_check_cadence(monkeypatch):
    """The old epoch's store must outlive the survivors' worst-case
    epoch discovery (check cadence + margin), not a fixed delay."""
    monkeypatch.setenv("ELASTICDL_STEP_SECS_BOUND", "5.0")
    monkeypatch.setenv("ELASTICDL_COLLECTIVE_HEARTBEAT", "10")
    # step-count cadence: 8 steps * 5 s bound + 2*10 s margin
    assert tdist.derive_reap_secs(check_steps=8) == 8 * 5.0 + 20.0
    # wall-clock cadence dominates when larger
    assert tdist.derive_reap_secs(check_steps=2, check_secs=120.0) == 140.0
    # no cadence configured: the default check interval + margin
    assert tdist.derive_reap_secs() == 20.0 + 20.0
    # the service default derives rather than hard-coding a delay
    svc = tdist.MasterCoordinationService()
    assert svc._reap_secs == tdist.derive_reap_secs()
    assert tdist.MasterCoordinationService(reap_secs=7.5)._reap_secs == 7.5
    # the group timeout is the same cadence bound, never torch's default
    assert tdist.collective_timeout_secs(4) == 4 * 5.0 + 20.0


# -- the controller cases of tests/test_master_recovery.py -----------------

def test_rendezvous_epoch_monotonic_across_restart(tmp_path):
    jdir = str(tmp_path)
    w = JournalWriter(jdir)
    rs1 = RendezvousServer(grace_secs=0.0, journal=w)
    rs1.add_worker("h0")
    rank, size, epoch1, _ = rs1.get_comm_rank("h0")
    assert (rank, size) == (0, 1) and epoch1 == 1
    rs1.add_worker("h1")
    _, _, epoch2, _ = rs1.get_comm_rank("h0")
    assert epoch2 == 2
    w.close()  # crash

    state = replay_journal(jdir)
    assert state.rendezvous_id == 2
    w2 = JournalWriter(jdir)
    rs2 = RendezvousServer(
        grace_secs=0.0, journal=w2,
        initial_epoch=state.rendezvous_id + 1,
    )
    # A reconnecting worker sees rank=-1 at an id strictly above any
    # epoch it can hold -> it re-announces instead of assuming its old
    # world is live.
    rank, _, epoch, _ = rs2.get_comm_rank("h0")
    assert rank == -1 and epoch >= epoch2 + 1
    rs2.add_worker("h0")
    rs2.add_worker("h1")
    rank, size, epoch3, _ = rs2.get_comm_rank("h0")
    assert (rank, size) == (0, 2)
    assert epoch3 > epoch2  # strictly monotone across the crash
    w2.close()
    assert replay_journal(jdir).rendezvous_id == epoch3


class _RendezvousMasterClient:
    """Fake MasterClient driving a RendezvousServer directly (the two
    RPCs the controller's world management uses)."""

    def __init__(self, rs, host):
        self.rs = rs
        self.host = host

    def get_comm_rank(self):
        rank, size, rid, addr = self.rs.get_comm_rank(self.host)
        return SimpleNamespace(
            rank_id=rank, world_size=size, rendezvous_id=rid,
            coordinator_addr=addr,
        )

    def report_train_loop_status(self, status):
        if status == pb.LOOP_START:
            self.rs.add_worker(self.host)
        else:
            self.rs.remove_worker(self.host)


def test_controller_reannounces_at_unchanged_restart_epoch():
    """The worst-case restart: the master re-arms at journaled+1,
    which EQUALS the un-journaled epoch a surviving worker glimpsed
    just before the crash.  The survivor sees rank=-1 at an UNCHANGED
    id against an empty committed world — it must re-announce anyway
    (id-change detection alone would leave both sides waiting
    forever)."""
    rs1 = RendezvousServer(grace_secs=0.0)
    mc = _RendezvousMasterClient(rs1, "h0")
    ctrl = ElasticCollectiveController(mc, trainer=object(),
                                       check_secs=0.0)
    mc.report_train_loop_status(pb.LOOP_START)
    assert ctrl.init_world_if_needed(force=True)
    # epoch 2: glimpsed by the worker, but (simulated) never durable
    rs1.add_worker("h1")
    assert ctrl.init_world_if_needed(force=True)
    glimpsed = ctrl._rendezvous.rendezvous_id
    assert glimpsed == 2

    # master crash + restart: journal held only epoch 1, re-armed at
    # 1 + 1 == the glimpsed id, committed world empty
    rs2 = RendezvousServer(grace_secs=0.0, initial_epoch=glimpsed)
    mc.rs = rs2
    # first check: rank=-1, id unchanged -> must still announce
    assert not ctrl.init_world_if_needed(force=True)
    assert "h0" in rs2._next_hosts
    # next check commits the post-restart epoch, strictly above
    assert ctrl.init_world_if_needed(force=True)
    assert ctrl._rendezvous.rank == 0
    assert ctrl._rendezvous.rendezvous_id > glimpsed


def test_first_world_waits_for_the_launched_workers(monkeypatch):
    """The master launches ``num_workers`` workers; the first epoch
    commits their world, not the first arrival's (a short job would run
    to its end in a world of one), and only after INITIAL_WORLD_WAIT_SECS
    without the rest does it commit the workers it has.  Later epochs do
    not wait."""
    from elasticdl_tpu_torch.master import rendezvous

    rs = RendezvousServer(grace_secs=0.0, initial_world=2)
    rs.add_worker("h0")
    assert rs.get_comm_rank("h0")[:3] == (-1, 0, 0)
    rs.add_worker("h1")
    assert rs.get_comm_rank("h0")[:3] == (0, 2, 1)
    assert rs.get_comm_rank("h1")[:3] == (1, 2, 1)
    rs.remove_worker("h1")
    assert rs.get_comm_rank("h0")[:3] == (0, 1, 2)

    late = RendezvousServer(grace_secs=0.0, initial_world=3)
    late.add_worker("h0")
    assert late.get_comm_rank("h0")[0] == -1
    monkeypatch.setattr(rendezvous, "INITIAL_WORLD_WAIT_SECS", 0.0)
    assert late.get_comm_rank("h0")[:3] == (0, 1, 1)
