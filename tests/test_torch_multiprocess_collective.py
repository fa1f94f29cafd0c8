"""The churn drill of tests/test_multiprocess_collective.py on port
processes: a managed 3-process job whose workers run real cross-process
collectives through the port's controller (elasticdl_tpu_torch/api/
controller.py) and ``initialize_from_rendezvous`` (parallel/
distributed.py), on gloo over the CPU.  One worker SIGKILLs itself
mid-run; the survivors' next collective fails in-band, the master
commits a world of 2 on a fresh store, the survivors re-form and train
on, and the relaunched replacement joins a world of 3 again.

Collective SGD on one scalar makes the trajectory checkable: every rank
holds w, the gradient of 0.5 w^2 is the mean of the ranks' w (which is w
while the replicas agree), so w <- 0.9 w; a re-formed world adopts rank
0's w (the epoch-start broadcast).  Exact checks: each survivor's w
falls strictly at every step, across both re-forms, and the replacement
starts from rank 0's w, not its own 4.0.  The ranks stop together: each
step's all-reduce also sums a "done" flag, which a survivor raises once
its last REGROWN_STEPS steps ran in the regrown world of 3 (or past the
drill's deadline), so every member of a world leaves at the same step.

The drill takes about 15 s on an 8-core CPU host, under a time limit of its
own (DRILL_TIMEOUT_S); it is not marked slow.
"""

import json
import os
import subprocess
import sys
import time

from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.parallel.distributed import (
    MasterCoordinationService,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # tools/ is repo tooling, not installed
    sys.path.insert(0, REPO)

from tools.elastic_lint.runtime_tracer import (  # noqa: E402
    LockDisciplineTracer,
)

DRILL_TIMEOUT_S = 120
# A survivor is done after this many steps in the regrown world...
REGROWN_STEPS = 5
# ... or this many seconds after the drill's start.
CHURN_SECS = 60

_CHURN_PROG = r"""
import json, os, sys, time

import torch
import torch.distributed as dist

torch.set_num_threads(1)
from elasticdl_tpu_torch.api.controller import ElasticCollectiveController
from elasticdl_tpu_torch.parallel.distributed import (
    initialize_from_rendezvous)
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.worker.master_client import MasterClient

worker_id = int(os.environ["WORKER_ID"])
deadline = float(os.environ["CHURN_END"])
regrown_steps = int(os.environ["CHURN_REGROWN_STEPS"])

ch = grpc_utils.build_channel(os.environ["MASTER_ADDR"])
grpc_utils.wait_for_channel_ready(ch)
mc = MasterClient(ch, worker_id=worker_id)


class ScalarTrainer:
    def __init__(self):
        self.w = 4.0
        self.world = 0

    def rebuild(self, world):
        self.world = world
        if world > 1:
            # Epoch-start state sync: everyone adopts rank 0's weight.
            t = torch.tensor([self.w])
            dist.broadcast(t, 0)
            self.w = float(t[0])


trainer = ScalarTrainer()
controller = ElasticCollectiveController(
    mc, trainer, check_steps=3, epoch_wait_secs=30,
    mesh_builder=lambda r, w, c: (
        initialize_from_rendezvous(r, w, c, timeout_secs=20), w)[1],
)
events = []
done = [False]


def finished():
    # 3 -> 2 -> 3 seen, the last steps all in the regrown world.
    worlds = [e["world"] for e in events]
    return time.time() > deadline or (
        3 in worlds and 2 in worlds[worlds.index(3):]
        and worlds[-regrown_steps:] == [3] * regrown_steps)


@controller.elastic_run
def train_step(step):
    t = torch.tensor([trainer.w, float(finished())])
    if trainer.world > 1:
        dist.all_reduce(t)
        t[0] /= trainer.world
    trainer.w -= 0.1 * float(t[0])
    done[0] = bool(t[1] > 0)
    events.append({"step": step, "world": trainer.world,
                   "w": round(trainer.w, 6)})


kill_self = os.environ.get("CHURN_KILL_SELF") == str(worker_id)
step = 0
with controller.scope():
    while not done[0]:
        train_step(step)
        # SIGKILL mid-run, no cleanup, at the 4th step in a world of 3
        # (workers that start a grace window apart first form a world of 2).
        if kill_self and sum(e["world"] == 3 for e in events) == 4:
            os.kill(os.getpid(), 9)
        step += 1
        time.sleep(0.1)

print("CHURN-DONE " + json.dumps(
    {"worker": worker_id, "events": events}), flush=True)
"""


class _ChurnBackend:
    """WorkerManager backend launching the churn program as real
    processes."""

    def __init__(self, kill_self_id, end):
        self._kill_self_id = kill_self_id
        self._end = end
        self.procs = {}

    def launch(self, worker_id, master_addr, slot=None, extra_env=None):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update(MASTER_ADDR=master_addr, WORKER_ID=str(worker_id),
                   CHURN_END=repr(self._end),
                   CHURN_REGROWN_STEPS=str(REGROWN_STEPS),
                   CHURN_KILL_SELF=str(self._kill_self_id),
                   OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHURN_PROG],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO,
        )
        self.procs[worker_id] = proc
        return proc

    def wait(self, ref):
        return ref.wait()

    def kill(self, ref, force=False):
        try:
            ref.kill() if force else ref.terminate()
        except ProcessLookupError:
            pass

    def is_alive(self, ref):
        return ref.poll() is None


def test_worker_churn_mid_collective_reforms_world():
    """3 -> 2 -> 3: a worker SIGKILLs itself at its 4th step in a world of
    3; the survivors
    re-form without it and grow back when its replacement joins, with the
    scalar-SGD trajectory strictly decreasing throughout."""
    start = time.monotonic()
    coord = MasterCoordinationService(reap_secs=30)
    rendezvous = RendezvousServer(
        grace_secs=0.7, coordinator_factory=coord.start_epoch)
    task_manager = TaskManager(training_shards=[("x", 0, 8)],
                               records_per_task=8)
    backend = _ChurnBackend(kill_self_id=2, end=time.time() + CHURN_SECS)
    manager = WorkerManager(backend, num_workers=3)
    master = Master(task_manager, rendezvous_server=rendezvous,
                    worker_manager=manager)
    # Dynamic EL001 over the real churn: the master-side epoch state is
    # hammered by gRPC pool threads, the worker watcher threads and this
    # thread; every access must hold the owner's lock.
    tracer = LockDisciplineTracer()
    tracer.register(rendezvous, attrs=[
        "_cur_hosts", "_next_hosts", "_rendezvous_id", "_last_change",
        "_coordinator_addr",
    ])
    tracer.register(task_manager, attrs=["_todo", "_doing"])
    try:
        master.prepare()
        deadline = start + DRILL_TIMEOUT_S
        while time.monotonic() < deadline:
            procs = dict(backend.procs)
            if len(procs) >= 4 and all(
                p.poll() is not None for p in procs.values()
            ):
                break
            time.sleep(0.5)
        results, logs = {}, {}
        for wid, proc in backend.procs.items():
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs[wid] = err
            for line in out.splitlines():
                if line.startswith("CHURN-DONE "):
                    results[wid] = json.loads(line[len("CHURN-DONE "):])
            if wid != 2 and wid not in results:
                raise AssertionError(
                    "worker %d produced no result:\n%s\n%s"
                    % (wid, out[-2000:], err[-3000:]))

        try:
            _check_churn(results)
        except AssertionError as e:
            raise AssertionError("%s\n%s" % (e, "\n".join(
                "worker %d:\n%s" % (w, log[-3000:])
                for w, log in logs.items()))) from None
        tracer.assert_clean()
    finally:
        tracer.restore()
        master.stop()
        coord.stop()
        for proc in backend.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert time.monotonic() - start < DRILL_TIMEOUT_S


def _check_churn(results):
    """The drill's outcome, from each worker's events."""
    # The killed worker never reports; its replacement (id 3) does.
    assert set(results) == {0, 1, 3}
    for wid in (0, 1):
        events = results[wid]["events"]
        worlds = [e["world"] for e in events]
        # Survivors saw the full cycle: the 3-world, the shrink to 2
        # after the in-band failure, and the regrowth to 3.
        assert 3 in worlds and 2 in worlds[worlds.index(3):], worlds
        assert worlds[-1] == 3, worlds
        assert len(events) >= 10, len(events)
        ws = [e["w"] for e in events]
        # Strictly decreasing until rounding territory (w decays
        # geometrically toward 0 and events carry 6 decimals), never
        # increasing anywhere, across both world changes.
        big = [w for w in ws if w > 1e-4]
        assert all(b < a for a, b in zip(big, big[1:])), big
        assert all(b <= a for a, b in zip(ws, ws[1:])), ws
    # The replacement joined a 3-world and synced to rank 0's w (not
    # its fresh init of 4.0) before training.
    repl = results[3]["events"]
    assert repl and repl[0]["world"] == 3, repl[:3]
    assert repl[0]["w"] < 3.6, repl[0]
    assert repl[-1]["w"] == results[0]["events"][-1]["w"]
