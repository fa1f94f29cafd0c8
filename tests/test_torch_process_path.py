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
    # The collective strategy is ported (ZeRO-1 on it too); continuous
    # export on it is not.
    (["--distribution_strategy", "collective", "--export_base", "/tmp/e",
      "--export_steps", "4"], "A11"),
    (["--distribution_strategy", "ps"], "A8"),
    (["--worker_backend", "k8s"], "A19"),
    (["--jobs_spec", "[]"], "A20"),
    (["--export_base", "/tmp/e", "--export_steps", "4"], "A11"),
])
def test_unported_flag_values_name_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=r"ROADMAP %s\b" % item):
        check_ported(parse_master_args(flags))
    if flags[0] not in ("--worker_backend", "--jobs_spec", "--status_port"):
        # A worker flag (master-only flags are not forwarded).
        with pytest.raises(NotImplementedError, match=item):
            check_ported(parse_worker_args(flags))


@pytest.mark.parametrize("flags", [
    ["--job_type", "predict"], ["--job_type", "evaluate"],
    ["--status_port", "0"], ["--profile_dir", "/tmp/p"],
    ["--profile_dir", "/tmp/p", "--zero1", "true"],
    ["--distribution_strategy", "collective", "--job_type", "predict",
     "--status_port", "0", "--profile_dir", "/tmp/p"]])
def test_ported_flag_values_pass_the_check(flags):
    """Predict and evaluate jobs (A21), the status server and device
    traces (A15) are ported: neither parser's check refuses them."""
    check_ported(parse_master_args(flags))
    if "--status_port" not in flags:      # a master-only flag
        check_ported(parse_worker_args(flags))


def test_master_cli_refuses_an_unported_path(job_env):
    job = Job(["--distribution_strategy", "ps", "--num_workers",
               "1"], *job_env)
    rc = job.finish(timeout=60)
    assert rc != 0
    assert "NotImplementedError" in job.log and "ROADMAP A8" in job.log
    assert "launched worker" not in job.log


COLLECTIVE_ARGS = ["--model_zoo", "mnist", "--batch_size", "16",
                   "--num_minibatches_per_task", "4",
                   "--distribution_strategy", "collective"]


def test_managed_collective_two_workers_form_world(job_env):
    """The port of tests/test_worker_e2e.py's managed elastic AllReduce
    job: two worker processes join one 2-rank world through the
    master-hosted store, train global batches in lockstep, survive the
    end-of-data shrink, and the job completes with no failed task."""
    # 8,192 records: a worker that starts a grace window before the other
    # trains alone for seconds before the world of 2 forms.
    job = Job(["--data_origin", "synthetic_mnist:8192", "--num_workers",
               "2"] + COLLECTIVE_ARGS, *job_env)
    rc = job.finish(timeout=240)
    log = job.log
    assert rc == 0, log
    assert re.search(r"job finished: .*'failed': \{0: 0", log), log
    assert "collective world joined: rank 0 / 2" in log
    assert "collective world joined: rank 1 / 2" in log
    assert log.count("adopted rank 0's parameters") >= 2


def test_collective_zero1_two_workers_checkpoint(job_env, tmp_path):
    """``--zero1 true`` on the collective strategy: two workers shard the
    optimizer state over their world of 2 (the placement line), both join
    the checkpoint cadence's gather while worker 0 alone writes, and the
    job ends exit 0 with no failed task."""
    ckpt = tmp_path / "ckpt"
    job = Job(["--data_origin", "synthetic_mnist:8192", "--num_workers", "2",
               "--zero1", "true", "--checkpoint_dir", str(ckpt),
               "--checkpoint_steps", "16"] + COLLECTIVE_ARGS, *job_env)
    rc = job.finish(timeout=240)
    log = job.log
    assert rc == 0, log
    assert re.search(r"job finished: .*'failed': \{0: 0", log), log
    for w in (0, 1):
        assert re.search(r"\[worker-%d\] .*zero1: optimizer state sharded 2 "
                         r"ways" % w, log), log
    assert any(name.startswith("version-") for name in os.listdir(ckpt))


def test_collective_kill_9_shrinks_and_grows_back(job_env):
    """kill -9 of one worker mid-job: the survivor's collective fails
    in-band, the master commits a world of 1 and relaunches the worker,
    the replacement joins a world of 2 again, and the job ends exit 0
    with no failed task."""
    job = Job(["--data_origin", "synthetic_mnist:16384", "--num_workers",
               "2", "--log_loss_steps", "10"] + COLLECTIVE_ARGS, *job_env)
    try:
        job.wait_for(r"adopted rank 0's parameters")
        job.wait_for(r"\[worker-0\] .* step 10 loss")
        os.kill(job.worker_pid(0), signal.SIGKILL)
        rc = job.finish(timeout=240)
    finally:
        job.finish(timeout=10)
    log = job.log
    assert rc == 0, log
    assert re.search(r"\[worker-1\] .*minibatch failed \(attempt 1\)",
                     log), log
    # Consecutive epochs: both workers, the survivor alone, the survivor
    # and the replacement (a world of 1 may come first, when one worker
    # started a grace window before the other, and last, at end of data).
    worlds = [re.findall(r"worker-\d", w) for w in re.findall(
        r"rendezvous epoch \d+: world=(\[[^]]*\])", log)]
    assert any(sorted(a) == ["worker-0", "worker-1"] and b == ["worker-1"]
               and c == ["worker-1", "worker-2"]
               for a, b, c in zip(worlds, worlds[1:], worlds[2:])), worlds
    assert "launched worker 2" in log
    assert re.search(r"\[worker-2\] .*collective world joined: rank \d / 2",
                     log), log
    assert re.search(r"task \d+ failed \(worker 0 died\), retry 1/3", log)
    assert re.search(r"job finished: .*'failed': \{0: 0", log), log


@pytest.mark.parametrize("zero1", [False, True])
def test_managed_collective_lora_finetune(job_env, zero1):
    """The port of tests/test_worker_e2e.py's managed collective LoRA job,
    with its flags: the LoRA zoo entry (a frozen base, two AdamW groups)
    under a 2-worker collective world completes with no failed task;
    with ``--zero1 true`` both workers shard the adapters' optimizer
    state over the world of 2."""
    cwd, env = job_env
    env = dict(env, ELASTICDL_COLLECTIVE_HEARTBEAT="5")
    flags = ["--model_zoo", "lora", "--model_params",
             "rank=4;vocab_size=128;dim=32;num_heads=4;num_layers=2;"
             "seq_len=16;dtype=float32",
             "--data_origin", "synthetic_lm:512:16:128",
             "--batch_size", "8", "--num_workers", "2",
             "--num_minibatches_per_task", "4",
             "--distribution_strategy", "collective"]
    if zero1:
        flags += ["--zero1", "true"]
    job = Job(flags, cwd, env)
    rc = job.finish(timeout=120)
    log = job.log
    assert rc == 0, log
    assert "job finished" in log
    assert "'failed': {0: 0" in log, log
    assert "collective world joined: rank 0 / 2" in log
    assert "LoRA r=4" in log
    placed = [re.search(r"\[worker-%d\] .*zero1: optimizer state sharded 2 "
                        r"ways" % w, log) for w in (0, 1)]
    assert all(placed) == zero1 and any(placed) == zero1, log


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
