"""The port's JobMonitor (elasticdl_tpu_torch/master/job_monitor.py, a
byte-identical copy: tests/test_torch_copies.py) probes a live PORT
master without disturbing the job: the twins of the 5 cases of
``tests/test_job_monitor.py`` under their names, on the port's master,
task manager, rendezvous and evaluation service."""

from elasticdl_tpu_torch.master.job_monitor import JobMonitor
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.task_manager import TaskManager


def test_snapshot_against_live_master():
    rendezvous = RendezvousServer(grace_secs=0.0)
    task_manager = TaskManager(
        training_shards=[("x", 0, 40)], records_per_task=10
    )
    master = Master(task_manager, rendezvous_server=rendezvous)
    master.prepare()
    try:
        monitor = JobMonitor("localhost:%d" % master.port, poll_secs=0)
        snap = monitor.snapshot()
        assert snap["reachable"]
        assert snap["world_size"] == 0  # nobody joined yet
        assert snap["dispatching"]     # WAIT or real work on offer
        # the probe must not consume real work: all 4 tasks remain
        counts = task_manager.counts()
        assert counts["todo"] + counts["doing"] == 4
        assert all(v == 0 for v in counts["failed"].values())
    finally:
        master.stop()


def test_snapshot_reports_unreachable():
    monitor = JobMonitor("localhost:1", poll_secs=0)
    snap = monitor.snapshot()
    assert not snap["reachable"]
    assert "error" in snap


def test_probe_never_burns_retries():
    """A monitor that happens to receive a real task must requeue it
    without consuming a retry — repeated probes must not permanently
    fail work."""
    task_manager = TaskManager(
        evaluation_shards=[("e", 0, 10)], records_per_task=10,
    )
    master = Master(task_manager)
    master.prepare()
    task_manager.create_evaluation_tasks(model_version=1)
    try:
        monitor = JobMonitor("localhost:%d" % master.port, poll_secs=0)
        for _ in range(10):  # way past max_task_retries
            monitor.snapshot()
        counts = task_manager.counts()
        assert all(v == 0 for v in counts["failed"].values()), counts
        assert counts["todo"] + counts["doing"] == 1  # task intact
        # retry budget untouched
        task = task_manager.get(0)
        assert task is not None and task.retry_count == 0
    finally:
        master.stop()


def test_probe_does_not_complete_eval_jobs():
    """A requeued eval task must not count toward evaluation-job
    completion (only real results do)."""
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService

    task_manager = TaskManager(
        evaluation_shards=[("e", 0, 10)], records_per_task=10,
    )
    eval_service = EvaluationService(task_manager, lambda: {},
                                     evaluation_steps=1)
    master = Master(task_manager, evaluation_service=eval_service)
    master.prepare()
    try:
        eval_service.add_evaluation_task_if_needed(model_version=1)
        monitor = JobMonitor("localhost:%d" % master.port, poll_secs=0)
        monitor.snapshot()  # peeks + requeues the eval task
        job = eval_service._job
        assert job is not None and job._completed_tasks == 0
    finally:
        master.stop()


def test_completion_in_next_creation_window_buffers(monkeypatch):
    """A completion landing inside job #2's creation window must be
    buffered and folded into job #2 — not applied to the retired,
    already-finished job #1, which would wedge job #2 one completion
    short forever and block every later evaluation."""
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService

    task_manager = TaskManager(
        evaluation_shards=[("e", 0, 10)], records_per_task=10,
    )
    eval_service = EvaluationService(task_manager, lambda: {},
                                     evaluation_steps=1)
    assert eval_service.add_evaluation_task_if_needed(model_version=1)
    eval_service.complete_task()  # the single task: job #1 finishes
    assert eval_service._job is None  # retired, not left in place
    assert [v for v, _ in eval_service.history] == [1]

    real_create = task_manager.create_evaluation_tasks

    def create_then_race(model_version):
        total = real_create(model_version)
        # a fast worker finishes a task before _job is assigned
        eval_service.complete_task()
        return total

    monkeypatch.setattr(
        task_manager, "create_evaluation_tasks", create_then_race
    )
    assert eval_service.add_evaluation_task_if_needed(model_version=2)
    # the raced completion reached job #2 (one task => finished), so
    # history gained exactly one entry and evaluation #3 is not wedged
    assert [v for v, _ in eval_service.history] == [1, 2]
    assert eval_service.add_evaluation_task_if_needed(model_version=3)
