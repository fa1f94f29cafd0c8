"""The port's parameter-server job, driven as a user drives it on the
CPU: ``python -m elasticdl_tpu_torch.master.main --distribution_strategy
ps --num_ps 2 --model_zoo deepfm --data_origin synthetic_ctr:N`` launches
two PS shards (``python -m elasticdl_tpu_torch.ps.server``) and two
workers (``ELASTICDL_TORCH_DEVICE=cpu``).

One shard is killed -9 once the checkpoint holds a committed label: the
master's ``PSManager`` relaunches it on its port, the new incarnation
restores its slice of that label, the workers ride the outage and
reconcile, and the job ends exit 0 with no failed task and its shard
checkpoints on disk.  A second job over the same checkpoint directory
resumes at the committed mark (``latest_resumable_version``): the master
skips the records it covers.

Jobs run from a directory outside the repo with stand-ins for ``jax``,
``jaxlib``, ``flax``, ``optax`` and ``elasticdl_tpu`` first on the
``PYTHONPATH`` that raise on import, so a finished job shows that none
of its processes (master, shards, workers) imported them.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "elasticdl_tpu")
PS_FLAGS = ["--model_zoo", "deepfm", "--batch_size", "32",
            "--num_workers", "2", "--num_minibatches_per_task", "4",
            "--distribution_strategy", "ps", "--num_ps", "2",
            "--checkpoint_steps", "16"]


@pytest.fixture(scope="module")
def job_env(tmp_path_factory):
    poison = tmp_path_factory.mktemp("banned")
    for name in BANNED:
        os.makedirs(poison / name)
        (poison / name / "__init__.py").write_text(
            "raise ImportError(%r)\n" % (
                "%s imported by a process of a port job" % name))
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

    def wait_for(self, pattern, timeout=60):
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

    def ps_pid(self, ps_id):
        """The pid of the master's child serving PS shard ``ps_id``."""
        path = "/proc/%d/task/%d/children" % (self.proc.pid, self.proc.pid)
        with open(path) as f:
            pids = [int(p) for p in f.read().split()]
        for pid in pids:
            with open("/proc/%d/cmdline" % pid, "rb") as f:
                argv = f.read().split(b"\0")
            if b"elasticdl_tpu_torch.ps.server" in argv and argv[
                    argv.index(b"--ps_id") + 1] == str(ps_id).encode():
                return pid
        raise AssertionError("no child serves PS %d" % ps_id)


def _wait_for_commit(ckpt, job, timeout=60):
    """The first label both shards have written."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert job.proc.poll() is None, job.log
        version = CheckpointSaver(str(ckpt)).latest_resumable_version(2)
        if version:
            return version
        time.sleep(0.05)
    raise AssertionError("no committed checkpoint:\n" + job.log)


def test_ps_job_rides_a_killed_shard_and_resumes(job_env, tmp_path):
    cwd, env = job_env
    ckpt = tmp_path / "ckpt"
    job = Job(["--data_origin", "synthetic_ctr:8192", "--checkpoint_dir",
               str(ckpt), "--log_loss_steps", "64"] + PS_FLAGS, cwd, env)
    try:
        committed = _wait_for_commit(ckpt, job)
        os.kill(job.ps_pid(0), signal.SIGKILL)
        job.wait_for(r"PS 0 died \(code -9\); relaunching with restore")
        restored = job.wait_for(r"restored PS shard 0 from version (\d+)")
        rc = job.finish(timeout=180)
    finally:
        job.finish(timeout=10)
    log = job.log
    assert rc == 0, log
    assert re.search(r"job finished: .*'failed': \{0: 0", log), log
    assert int(re.search(r"version (\d+)", restored).group(1)) >= committed
    assert re.search(r"launched PS 0 on port \d+ \(restore=True, "
                     r"generation hint 2\)", log), log
    # Both workers trained on the CPU against the two shards, and rode
    # the relaunch: neither died, and a reconcile ran.
    for w in (0, 1):
        assert re.search(r"worker %d training on cpu against PS" % w, log)
    assert "launched worker 2" not in log
    assert "reconciled PS restart" in log, log
    saver = CheckpointSaver(str(ckpt))
    latest = saver.latest_resumable_version(2)
    assert latest and latest > committed
    dense, tables, _ = saver._load_all(latest)
    assert {"w0", "b0", "bias"} <= set(dense)
    assert {"deepfm_embedding", "deepfm_linear"} <= set(tables)

    # A second job over the same directory resumes at the committed mark.
    again = Job(["--data_origin", "synthetic_ctr:8192", "--checkpoint_dir",
                 str(ckpt)] + PS_FLAGS, cwd, env)
    rc = again.finish(timeout=180)
    assert rc == 0, again.log
    skipped = int(re.search(r"resume: skipped (\d+) records",
                            again.log).group(1))
    assert skipped == min(8192, latest * 32), again.log
    assert re.search(r"job finished: .*'failed': \{0: 0", again.log)
