"""The port's master/worker process path, driven as a user drives it:
``python -m elasticdl_tpu_torch.master.main`` launching
``python -m elasticdl_tpu_torch.worker.main`` subprocesses (the verify
skill's happy path, preemption drills and failure probe), on the CPU
with ``ELASTICDL_TORCH_DEVICE=cpu``.

Every job here runs from a directory outside the repo with a
``PYTHONPATH`` whose first entry holds stand-ins for ``jax``,
``jaxlib``, ``flax``, ``optax`` and ``elasticdl_tpu`` that refuse to
import: a master or worker that imported any of them would die, so a
finished job shows that no process of a port job imports JAX or the JAX
package.

Each subprocess wait and thread join has a time limit.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from elasticdl_tpu_torch.master import worker_manager
from elasticdl_tpu_torch.utils.args import (
    check_ported,
    parse_master_args,
    parse_worker_args,
)
from elasticdl_tpu_torch.worker import main as worker_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_ARGS = ["--model_zoo", "mnist", "--batch_size", "32",
            "--num_minibatches_per_task", "4"]
BANNED = ("jax", "jaxlib", "flax", "optax", "elasticdl_tpu")


@pytest.fixture(scope="module")
def job_env(tmp_path_factory):
    """(cwd, env) for a port job: the CPU, and the banned packages
    shadowed by stand-ins that raise on import."""
    poison = tmp_path_factory.mktemp("banned")
    for name in BANNED:
        os.makedirs(poison / name)
        (poison / name / "__init__.py").write_text(
            "raise ImportError(%r)\n" % (
                "%s imported by a process of a port job" % name))
    # One intra-op thread a process: a master and three workers share
    # the test machine's cores with other test files.
    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(poison), REPO])
    return str(tmp_path_factory.mktemp("cwd")), env


class Job:
    """A master process with its log collected by a reader thread."""

    def __init__(self, args, cwd, env):
        self.lines = []
        self._cond = threading.Condition()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.master.main"]
            + args, cwd=cwd, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stderr:
            with self._cond:
                self.lines.append(line)
                self._cond.notify_all()

    def wait_for(self, pattern, timeout=90):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if re.search(pattern, line):
                        return line
                left = deadline - time.monotonic()
                assert left > 0 and self.proc.poll() is None, (
                    "no %r in the log:\n%s" % (pattern, self.log))
                self._cond.wait(min(left, 0.5))

    def finish(self, timeout=120):
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=10)
            self._reader.join(timeout=10)
        return rc

    @property
    def log(self):
        with self._cond:
            return "".join(self.lines)

    def worker_pid(self, worker_id):
        """The pid of the master's child running worker ``worker_id``."""
        path = "/proc/%d/task/%d/children" % (self.proc.pid, self.proc.pid)
        with open(path) as f:
            pids = [int(p) for p in f.read().split()]
        for pid in pids:
            with open("/proc/%d/environ" % pid, "rb") as f:
                env = f.read().split(b"\0")
            if b"WORKER_ID=%d" % worker_id in env:
                return pid
        raise AssertionError("no child runs worker %d" % worker_id)


@pytest.mark.parametrize("evaluation", [False, True])
def test_happy_path(job_env, evaluation):
    """The verify skill's happy path; with ``evaluation``, evaluation
    tasks of a validation set interleave with training."""
    extra = (["--validation_data_origin", "synthetic_mnist:128",
              "--evaluation_steps", "4"] if evaluation else [])
    job = Job(["--data_origin", "synthetic_mnist:512", "--num_epochs", "1",
               "--num_workers", "2"] + JOB_ARGS + extra, *job_env)
    rc = job.finish()
    assert rc == 0, job.log
    assert "job finished" in job.log
    assert re.search(r"'failed': \{0: 0", job.log)
    assert job.log.count("training on cpu") == 2
    assert ("evaluation @ version" in job.log) == evaluation


def test_kill_9_of_a_worker_requeues_its_task(job_env):
    job = Job(["--data_origin", "synthetic_mnist:2048", "--num_epochs", "1",
               "--num_workers", "2", "--log_loss_steps", "1"] + JOB_ARGS,
              *job_env)
    try:
        # Worker 0 is in its first task (4 steps): 3 steps to go.
        job.wait_for(r"\[worker-0\] .* step 1 loss")
        os.kill(job.worker_pid(0), signal.SIGKILL)
        rc = job.finish()
    finally:
        job.finish(timeout=10)
    assert rc == 0, job.log
    assert re.search(r"task \d+ failed \(worker 0 died\), retry 1/3",
                     job.log), job.log
    assert "launched worker 2" in job.log
    assert re.search(r"job finished: .*'failed': \{0: 0", job.log), job.log


def test_sigterm_checkpoints_exits_143_and_is_relaunched(job_env, tmp_path):
    """Graceful preemption on the fused path: the worker finishes its
    window, checkpoints, hands its task back and exits 143; a new worker
    restores the checkpoint and the job finishes with no failed task."""
    ckpt = tmp_path / "ckpt"
    job = Job(["--data_origin", "synthetic_mnist:2048", "--num_epochs", "1",
               "--num_workers", "2", "--log_loss_steps", "4",
               "--fused_steps", "4", "--checkpoint_dir", str(ckpt),
               "--checkpoint_steps", "1000"] + JOB_ARGS, *job_env)
    try:
        job.wait_for(r"\[worker-0\] .*fused_driver.* step 4 loss")
        os.kill(job.worker_pid(0), signal.SIGTERM)
        job.wait_for(r"worker 0 exited code=143")
        rc = job.finish()
    finally:
        job.finish(timeout=10)
    assert rc == 0, job.log
    log = job.log
    for expected in ("SIGTERM received: graceful preemption",
                     "graceful preemption: saving checkpoint",
                     "launched worker 2", "restored checkpoint version"):
        assert expected in log, expected
    assert re.search(r"job finished: .*'failed': \{0: 0", log), log
    assert any(name.startswith("version-") for name in os.listdir(ckpt))


def test_unknown_model_exits_1_fast(job_env):
    start = time.monotonic()
    job = Job(["--data_origin", "synthetic_mnist:64", "--num_workers", "1",
               "--model_zoo", "no_such_model"], *job_env)
    rc = job.finish(timeout=60)
    assert rc == 1, job.log
    assert "ModuleNotFoundError" in job.log
    assert "launched worker" not in job.log
    assert time.monotonic() - start < 60


@pytest.mark.parametrize("flags,item", [
    (["--distribution_strategy", "collective"], "A4"),
    (["--distribution_strategy", "ps"], "A8"),
    (["--worker_backend", "k8s"], "A19"),
    (["--jobs_spec", "[]"], "A20"),
    (["--job_type", "predict"], "A21"),
    (["--job_type", "evaluate"], "A21"),
    (["--status_port", "0"], "A15"),
    (["--profile_dir", "/tmp/p"], "A15"),
    (["--zero1", "true"], "A6"),
    (["--export_base", "/tmp/e", "--export_steps", "4"], "A11"),
])
def test_unported_flag_values_name_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=r"ROADMAP %s\b" % item):
        check_ported(parse_master_args(flags))
    if flags[0] not in ("--worker_backend", "--jobs_spec", "--status_port"):
        # A worker flag (master-only flags are not forwarded).
        with pytest.raises(NotImplementedError, match=item):
            check_ported(parse_worker_args(flags))


def test_master_cli_refuses_an_unported_path(job_env):
    job = Job(["--distribution_strategy", "collective", "--num_workers",
               "1"], *job_env)
    rc = job.finish(timeout=60)
    assert rc != 0
    assert "NotImplementedError" in job.log and "ROADMAP A4" in job.log
    assert "launched worker" not in job.log


def test_process_backend_sets_no_device_variable(monkeypatch):
    launched = {}

    def popen(cmd, env):
        launched.update(cmd=cmd, env=env)
        return "proc"

    monkeypatch.setattr(worker_manager.subprocess, "Popen", popen)
    backend = worker_manager.ProcessWorkerBackend(worker_args=["--seed", "3"])
    assert backend.launch(5, "localhost:1234") == "proc"
    assert launched["cmd"][1:] == [
        "-m", "elasticdl_tpu_torch.worker.main", "--seed", "3"]
    want = dict(os.environ, MASTER_ADDR="localhost:1234", WORKER_ID="5")
    assert launched["env"] == want


def test_worker_device_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("ELASTICDL_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert worker_main.worker_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker_main.worker_device()
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")
    assert worker_main.worker_device() == torch.device("cpu")


def test_worker_launched_without_a_device_variable_raises_here(job_env):
    cwd, env = job_env
    env = dict(env)
    del env["ELASTICDL_TORCH_DEVICE"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--master_addr", "localhost:1"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
