"""The port's multi-tenant scheduler (elasticdl_tpu_torch/master/
scheduler.py, a byte-identical copy: tests/test_torch_copies.py) against
the JAX package's, on the CPU.

``scheduler.py`` runs on each package's own task manager, servicer,
journal, rendezvous, tracing and timing, so the two are driven in
process through one scripted sequence — registrations, ``get_task``
handshakes, task results routed by job id (colliding task ids and an
unscoped report among them), a finished job, controller ticks, an
admission from the queue, and a journal replay into a fresh registry —
and must give the same assignment maps after each step, the same
``sched`` journal records and the same per-job task counts.  The policy
(``compute_targets``) agrees over seeded random pools and job sets.

Then the slice end to end on port worker processes: a ``--jobs_spec``
master with two mnist jobs over a pool of two workers.  Every record of
each job is accounted for once (each job's journal), no worker restarts
(the pids), at least one controller-driven move (a ``sched`` assign with
a ``prev``) in one trace component with the worker's
``worker.job_switch`` span, and the moved worker's first loss in its new
job equal, bitwise, to a fresh port trainer's with the job's seed on the
same batch (the contract of tests/test_torch_master_worker.py: the task
loop adds no arithmetic to a step).
"""

import importlib
import json
import os
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.journal import (
    journal_path,
    replay_journal,
    scan_frames,
)
from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
from tests.test_torch_process_path import Job, job_env  # noqa: F401


def _modules(package):
    def mod(name):
        return importlib.import_module("%s.%s" % (package, name))

    return SimpleNamespace(
        sched=mod("master.scheduler"), journal=mod("master.journal"),
        tm=mod("master.task_manager"), servicer=mod("master.servicer"),
        pb=mod("proto.elastic_pb2"))


def _sched_records(journal_mod, jdir):
    with open(journal_mod.journal_path(jdir), "rb") as f:
        data = f.read()
    return [rec for rec, _ in journal_mod.scan_frames(data)
            if rec.get("ev") == "sched"]


def _drive(package, jdir):
    """The scripted sequence on ``package``'s control plane; returns its
    transcript (JSON-able)."""
    m = _modules(package)
    p = m.pb
    journal = m.journal.JournalWriter(jdir)
    registry = m.sched.JobRegistry(journal=journal, pool_size=3)
    jobs = []
    for job_id, (name, n_tasks, kw) in enumerate((
            ("a", 1, {}),
            ("b", 6, {"max_workers": 2, "weight": 2.0}),
            ("c", 3, {"min_workers": 2})), start=1):
        tm = m.tm.TaskManager(training_shards=[("f", 0, 32 * n_tasks)],
                              records_per_task=32)
        spec = m.sched.JobSpec(name, data_origin="synthetic_mnist:%d"
                               % (32 * n_tasks), seed=job_id, **kw)
        servicer = m.servicer.MasterServicer(tm, job_id=job_id)
        job = m.sched.ManagedJob(job_id, spec, tm, servicer)
        registry.submit(job)
        jobs.append(job)
    controller = m.sched.ResizeController(registry, moves_per_tick=1)
    sv = m.sched.MultiTenantServicer(registry)
    out = []
    held = {}

    def snap(label):
        status = registry.status()
        out.append({
            "at": label,
            "assignments": status["assignments"],
            "workers_assigned": status["workers_assigned"],
            "pending_jobs": status["pending_jobs"],
            "states": [j.state for j in jobs],
            "counts": [j.task_manager.counts() for j in jobs],
        })

    def poll(wid):
        prev = held.get(wid)
        res = sv.get_task(p.GetTaskRequest(
            worker_id=wid, job_id=prev.job_id if prev else 0))
        held[wid] = res
        out.append({"poll": wid, "job": res.job_id, "task": res.task.id,
                    "type": int(res.task.type), "task_job": res.task.job_id,
                    "config": json.loads(res.job_config)
                    if res.job_config else None})
        return res

    def finish(wid):
        res = held[wid]
        sv.report_batch_done(p.ReportBatchDoneRequest(
            worker_id=wid, record_count=32, job_id=res.job_id,
            steps_per_sec=4.0 + wid, steps_done=1))
        sv.report_task_result(p.ReportTaskResultRequest(
            task_id=res.task.id, job_id=res.job_id))

    def replay(label):
        """The journal so far, replayed into a fresh registry (a
        restarted master's)."""
        journal.flush()
        state = m.journal.replay_journal(jdir)
        restored = m.sched.JobRegistry(pool_size=0)
        for job in jobs:
            tm = m.tm.TaskManager(training_shards=[("f", 0, 32)],
                                  records_per_task=32)
            restored.submit(m.sched.ManagedJob(
                job.job_id, job.spec, tm,
                m.servicer.MasterServicer(tm, job_id=job.job_id)),
                journal=False)
        restored.restore_from_journal(state)
        out.append({
            "replayed_at": label,
            "assignments": {str(k): v for k, v in
                            state.sched_assignments.items()},
            "decisions": dict(state.sched_decisions),
            "states": {str(k): v["state"] for k, v in
                       state.sched_jobs.items()},
            "restored": restored.status()["assignments"],
            "restored_states": [j.state for j in restored.jobs()],
        })

    for wid in range(3):
        poll(wid)
    snap("registered")
    # Task ids collide across jobs: a result routes by job id alone, and
    # an unscoped one (job id 0) is dropped.
    sv.report_task_result(p.ReportTaskResultRequest(task_id=1))
    snap("unscoped result dropped")
    for _ in range(8):
        for wid in range(3):
            if held[wid].task.id > 0:
                finish(wid)
        moves = controller.tick()
        out.append({"moves": [list(mv) for mv in moves]})
        snap("tick")
        if moves:
            replay("mid-resize")
        for wid in range(3):
            poll(wid)
        if registry.all_finished():
            break
    snap("end")
    journal.close()
    replay("end")
    out.append({"sched": _sched_records(m.journal, jdir)})
    return json.loads(json.dumps(out))


def test_scheduler_matches_the_reference_decision_for_decision(tmp_path):
    want = _drive("elasticdl_tpu", str(tmp_path / "jax"))
    got = _drive("elasticdl_tpu_torch", str(tmp_path / "port"))
    assert got == want
    moves = [e for e in got if "moves" in e and e["moves"]]
    assert moves, "the sequence made no controller move"
    assert any(rec["op"] == "assign" and rec.get("prev")
               for rec in got[-1]["sched"])
    assert any(rec["op"] == "admit" and rec["job"] == 3
               for rec in got[-1]["sched"][3:])   # c, from the queue
    mid = next(e for e in got if e.get("replayed_at") == "mid-resize")
    assert mid["restored"] == mid["assignments"] != {}


def test_compute_targets_matches_the_reference_on_random_pools():
    from elasticdl_tpu.master.scheduler import compute_targets as jtargets
    from elasticdl_tpu_torch.master.scheduler import compute_targets

    rng = np.random.RandomState(20)
    for _ in range(500):
        pool = int(rng.randint(0, 13))
        jobs = []
        for job_id in range(1, int(rng.randint(1, 6)) + 1):
            low = int(rng.randint(0, 4))
            jobs.append({
                "id": job_id, "min": low,
                "max": int(rng.choice([0, low, low + int(rng.randint(
                    1, 5))])),
                "weight": float(rng.choice([0.5, 1.0, 2.0, 3.0])
                                * rng.uniform(0.5, 1.5)),
                "demand": int(rng.choice([0, 1, 2, 5, 100])),
            })
        assert compute_targets(pool, jobs) == jtargets(pool, jobs), (
            pool, jobs)


# -- the slice end to end, on port worker processes -------------------------

JOBS = [
    {"name": "jobA", "data_origin": "synthetic_mnist:256", "seed": 3,
     "min_workers": 1, "max_workers": 2},
    {"name": "jobB", "data_origin": "synthetic_mnist:1024", "seed": 5,
     "min_workers": 1, "max_workers": 2},
]
RECORDS_PER_TASK = 32 * 4


def _journal(jdir, sub):
    with open(journal_path(os.path.join(jdir, sub)), "rb") as f:
        return [rec for rec, _ in scan_frames(f.read())]


def _worker_pids(master_pid):
    """{pid: worker id} of the master's children that run a worker: the
    children file lists their threads too (a thread's parent is its
    process's), so only thread-group leaders count."""
    out = {}
    try:
        with open("/proc/%d/task/%d/children" % (master_pid,
                                                 master_pid)) as f:
            children = [int(p) for p in f.read().split()]
    except OSError:
        return out
    for pid in children:
        try:
            with open("/proc/%d/status" % pid) as f:
                tgid = next(int(line.split()[1]) for line in f
                            if line.startswith("Tgid:"))
            if tgid != pid:
                continue
            with open("/proc/%d/environ" % pid, "rb") as f:
                env = f.read().split(b"\0")
        except (OSError, StopIteration):
            continue
        for item in env:
            if item.startswith(b"WORKER_ID="):
                out[pid] = int(item[len(b"WORKER_ID="):])
    return out


def _fresh_first_loss(job, task):
    """A fresh port trainer's loss on the first batch of ``task`` (a
    journal ``task`` record) of ``job``, seeded as the job; one intra-op
    thread, as the workers run."""
    spec = mnist.model_spec()
    reader = create_data_reader(job["data_origin"],
                                records_per_shard=RECORDS_PER_TASK)
    task_pb = pb.TaskPB(id=task["id"], type=pb.TRAINING, shard=pb.ShardPB(
        name=task["name"], start=task["start"], end=task["end"]))
    features, labels, _ = next(TaskDataService(reader, spec.feed)
                               .batch_stream(task_pb, 32))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = CollectiveTrainer(spec, batch_size=32, device="cpu",
                                    rng_seed=job["seed"])
        loss, _ = trainer.train_minibatch(features, labels)
        return float(loss)
    finally:
        torch.set_num_threads(threads)


def test_two_job_pool_on_port_workers(job_env, tmp_path):  # noqa: F811
    cwd, env = job_env
    jdir, tdir = str(tmp_path / "journal"), str(tmp_path / "traces")
    spec_path = str(tmp_path / "jobs.json")
    with open(spec_path, "w") as f:
        json.dump(JOBS, f)
    job = Job(["--jobs_spec", spec_path, "--num_workers", "2",
               "--model_zoo", "mnist", "--batch_size", "32",
               "--num_minibatches_per_task", "4", "--sched_cadence_secs",
               "0.5", "--journal_dir", jdir, "--log_loss_steps", "1"],
              cwd, dict(env, ELASTICDL_TRACE_DIR=tdir))
    pids = {}
    try:
        deadline = time.monotonic() + 120
        while job.proc.poll() is None and time.monotonic() < deadline:
            pids.update(_worker_pids(job.proc.pid))
            time.sleep(0.05)
        rc = job.finish(timeout=10)
    finally:
        job.finish(timeout=10)
    log = job.log
    assert rc == 0, log
    # No worker restarts: the two launched workers are the only ones.
    assert sorted(pids.values()) == [0, 1], pids
    assert log.count("launched worker") == 2, log
    assert "relaunch=True" not in log

    # Every record of each job once, from its own journal.
    for job_id, spec in enumerate(JOBS, start=1):
        recs = _journal(jdir, "job-%02d" % job_id)
        n_records = int(spec["data_origin"].split(":")[1])
        tasks = [r for r in recs if r["ev"] == "task"]
        done = [r["id"] for r in recs if r["ev"] == "done"]
        assert sorted(done) == sorted(t["id"] for t in tasks)
        assert len(tasks) == n_records // RECORDS_PER_TASK
        assert sum(r["n"] for r in recs if r["ev"] == "batch") == n_records
        state = replay_journal(os.path.join(jdir, "job-%02d" % job_id))
        assert sum(state.failed_counts.values()) == 0

    # At least one move, decided by the controller.
    moves = [r for r in _journal(jdir, "sched")
             if r.get("ev") == "sched" and r["op"] == "assign"
             and r.get("prev")]
    assert moves, log
    move = moves[0]
    assert (move["prev"], move["job"]) == (1, 2)

    # The decision, the hand-over and the rebuild in one trace component.
    components = tracing.trace_components(tracing.load_dumps(tdir))
    assert any({"sched.resize", "sched.worker_reassigned",
                "worker.job_switch"} <= {e["name"] for e in c}
               for c in components)

    # The moved worker's first loss in jobB: a fresh trainer's, bitwise.
    wid = move["w"]
    lines = [line for line in log.splitlines()
             if "[worker-%d]" % wid in line]
    at = max(i for i, line in enumerate(lines)
             if "switched to job jobB" in line)
    first = next(re.search(r"step \d+ loss (\S+) ", line).group(1)
                 for line in lines[at:] if " loss " in line)
    recs = _journal(jdir, "job-02")
    task_id = next(r["id"] for r in recs
                   if r["ev"] == "dispatch" and r["w"] == wid)
    task = next(r for r in recs if r["ev"] == "task" and r["id"] == task_id)
    assert float(first) == _fresh_first_loss(JOBS[1], task), (first, task)


def test_impossible_min_workers_fails_fast(tmp_path):
    """The reference's fail-fast on a job whose floor exceeds the pool;
    and, since the port's master launches its pool before it imports
    torch, a ``model_zoo`` that names no module is refused before any
    worker starts, as the single-job master refuses one."""
    from elasticdl_tpu_torch.master.main import build_multitenant_master
    from elasticdl_tpu_torch.utils.args import parse_master_args

    spec_path = str(tmp_path / "jobs.json")
    with open(spec_path, "w") as f:
        json.dump([{"name": "a", "min_workers": 8,
                    "data_origin": "synthetic_mnist:128"}], f)
    args = parse_master_args(
        ["--jobs_spec", spec_path, "--num_workers", "4"])
    with pytest.raises(ValueError, match="could never be admitted"):
        build_multitenant_master(args)
    with open(spec_path, "w") as f:
        json.dump([{"name": "a", "model_zoo": "no_such_model",
                    "data_origin": "synthetic_mnist:128"}], f)
    with pytest.raises(ModuleNotFoundError, match="no_such_model"):
        build_multitenant_master(args)
