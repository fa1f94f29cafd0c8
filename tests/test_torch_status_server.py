"""The port's master HTTP observability surface
(elasticdl_tpu_torch/master/status_server.py): the twins of
tests/test_status_server.py's two master tests (the PS one waits for
ROADMAP A8), the CLI's ``--status_port``, and ``/profilez`` and
``device_trace`` over the port's ``torch.profiler`` adapter
(``utils/timing.TorchProfiler``).

A profile is a Chrome-trace JSON file (``traceEvents``).  On this CPU
the adapter records CPU activity only: it adds CUDA activity just when
the process has already initialised CUDA, which
``test_profiler_asks_for_cuda_only_after_cuda_is_initialised`` pins by
the activities it hands ``torch.profiler``.
"""

import glob
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

from elasticdl_tpu_torch.master.status_server import (
    StatusServer,
    to_prometheus,
)
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import timing, tracing
from tests.test_torch_elastic_controller import (
    create_master,
    create_master_client,
)
from tests.test_torch_process_path import Job, job_env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port, path):
    with urllib.request.urlopen(
        "http://127.0.0.1:%d%s" % (port, path), timeout=30
    ) as resp:
        return resp.status, resp.read().decode()


def _metrics(text):
    return dict(line.rsplit(" ", 1) for line in text.strip().splitlines()
                if not line.startswith("#"))


def test_status_endpoints_reflect_job_state():
    master = create_master([("f", 0, 64)], records_per_task=16)
    server = StatusServer(
        master.task_manager,
        rendezvous_server=master.rendezvous_server,
        servicer=master.servicer,
        host="127.0.0.1",
    )
    server.start()
    try:
        code, body = _get(server.port, "/healthz")
        assert (code, body) == (200, "ok\n")

        mc = create_master_client(master, worker_id=0)
        mc.report_train_loop_status(pb.LOOP_START)
        task = mc.get_task()
        mc.report_task_result(task.id)  # one task completed

        code, body = _get(server.port, "/status")
        assert code == 200
        status = json.loads(body)
        assert status["tasks"]["completed"][str(pb.TRAINING)] == 1
        assert status["tasks"]["todo"] == 3
        assert status["finished"] is False
        assert status["rendezvous"]["world"] in ([], ["worker-0"])

        code, text = _get(server.port, "/metrics")
        assert code == 200
        metrics = _metrics(text)
        assert metrics["elasticdl_tasks_todo"] == "3"
        assert metrics['elasticdl_tasks_completed{type="0"}'] == "1"
        assert metrics["elasticdl_job_finished"] == "0"

        with pytest.raises(urllib.error.HTTPError) as err:
            _get(server.port, "/nope")
        assert err.value.code == 404
    finally:
        server.stop()
        master.stop()


def test_prometheus_rendering_shapes():
    status = {
        "tasks": {"todo": 2, "doing": 1, "epoch": 0,
                  "completed": {0: 5}, "failed": {0: 0}},
        "finished": False,
        "workers": {"live": [0, 2]},
        "rendezvous": {"epoch": 3, "world": ["a", "b"]},
        "exec_counters": {"batch_count": 17},
    }
    text = to_prometheus(status)
    assert 'elasticdl_tasks_completed{type="0"} 5' in text
    assert "elasticdl_workers_live 2" in text
    assert "elasticdl_rendezvous_world_size 2" in text
    assert 'elasticdl_worker_counter{name="batch_count"} 17' in text


def test_cli_master_serves_its_status_port(job_env):  # noqa: F811
    """``--status_port 0`` on the port's master CLI: it logs the port it
    bound, and serves /healthz, /status, /metrics (the same task counts
    as /status) and /tracez while the job waits for its workers."""
    job = Job(["--data_origin", "synthetic_mnist:128", "--model_zoo",
               "mnist", "--batch_size", "32", "--num_minibatches_per_task",
               "2", "--num_workers", "0", "--status_port", "0"], *job_env)
    try:
        line = job.wait_for(r"status server on port \d+", timeout=120)
        port = int(re.search(r"status server on port (\d+)", line).group(1))
        assert _get(port, "/healthz") == (200, "ok\n")
        status = json.loads(_get(port, "/status")[1])
        assert status["tasks"]["todo"] == 2 and status["finished"] is False
        metrics = _metrics(_get(port, "/metrics")[1])
        assert metrics["elasticdl_tasks_todo"] == str(
            status["tasks"]["todo"])
        assert metrics["elasticdl_tasks_doing"] == str(
            status["tasks"]["doing"])
        for kind, n in status["tasks"]["completed"].items():
            assert metrics['elasticdl_tasks_completed{type="%s"}' % kind] \
                == str(n)
        tracez = json.loads(_get(port, "/tracez")[1])
        assert tracez["process"]["role"] == "master"
        assert isinstance(tracez["events"], list)
        alertz = json.loads(_get(port, "/alertz")[1])
        assert "stragglers" in json.dumps(alertz)
    finally:
        job.proc.kill()
        job.finish(timeout=30)


def _chrome_trace(path):
    with open(path) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    return trace


def test_profilez_writes_a_torch_trace_and_refuses_while_a_device_trace_runs(
        tmp_path, monkeypatch):
    monkeypatch.setenv(tracing.ENV_TRACE_DIR, str(tmp_path / "profilez"))
    master = create_master([("f", 0, 8)], 8)
    server = StatusServer(master.task_manager, host="127.0.0.1")
    server.start()
    try:
        reply = json.loads(_get(server.port, "/profilez?secs=0.2")[1])
        assert reply["ok"] is True, reply
        assert reply["secs"] == pytest.approx(0.2)
        assert os.path.dirname(reply["file"]) == reply["dir"]
        assert reply["dir"].startswith(str(tmp_path / "profilez"))
        _chrome_trace(reply["file"])
        # While device_trace runs in this process, /profilez answers with
        # the error dict and the running trace goes on to write its file.
        with timing.device_trace(str(tmp_path / "device")):
            busy = json.loads(_get(server.port, "/profilez?secs=0.1")[1])
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert busy["ok"] is False
        assert "already running" in busy["error"], busy
        written = timing.PROFILER.last_trace
        assert os.path.dirname(written) == str(tmp_path / "device")
        names = {e.get("name") for e in _chrome_trace(written)["traceEvents"]}
        assert "aten::mm" in names
        # Free again once the device trace stopped.
        again = json.loads(_get(server.port, "/profilez?secs=0")[1])
        assert again["ok"] is True, again
    finally:
        server.stop()
        master.stop()


def test_profiler_asks_for_cuda_only_after_cuda_is_initialised(
        monkeypatch, tmp_path):
    asked = []
    real = torch.profiler.profile

    def profile(activities):
        asked.append(sorted(a.name for a in activities))
        return real(activities=[torch.profiler.ProfilerActivity.CPU])

    monkeypatch.setattr(torch.profiler, "profile", profile)
    for initialised in (False, True):
        monkeypatch.setattr(torch.cuda, "is_initialized",
                            lambda v=initialised: v)
        prof = timing.TorchProfiler()
        prof.start_trace(str(tmp_path))
        with pytest.raises(RuntimeError, match="already running"):
            prof.start_trace(str(tmp_path))
        prof.stop_trace()
        with pytest.raises(RuntimeError, match="no device trace"):
            prof.stop_trace()
    assert asked == [["CPU"], ["CPU", "CUDA"]]


_NO_CONTEXT = r"""
import json, sys, torch
from elasticdl_tpu_torch.utils import tracing
reply = tracing.profilez_capture(0.05, trace_dir=sys.argv[1])
print(json.dumps({"ok": reply["ok"], "file": reply.get("file"),
                  "cuda": torch.cuda.is_initialized()}))
"""


def test_profilez_creates_no_cuda_context(tmp_path):
    """In a fresh process, as a master is: a capture leaves CUDA
    uninitialised."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_CONTEXT, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True)
    reply = json.loads(out.stdout.strip().splitlines()[-1])
    assert reply["ok"] is True and reply["cuda"] is False
    assert os.path.basename(reply["file"]).startswith("proc-na-")
    _chrome_trace(reply["file"])


def test_worker_profile_dir_leaves_a_chrome_trace(job_env,  # noqa: F811
                                                  tmp_path):
    profile_dir = str(tmp_path / "profile")
    job = Job(["--data_origin", "synthetic_mnist:128", "--model_zoo",
               "mnist", "--batch_size", "32", "--num_minibatches_per_task",
               "2", "--num_workers", "1", "--profile_dir", profile_dir],
              *job_env)
    assert job.finish(timeout=180) == 0, job.log
    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    assert len(files) == 1, job.log
    assert re.fullmatch(r"worker-0-\d+\.pt\.trace\.json",
                        os.path.basename(files[0]))
    names = {e.get("name") for e in _chrome_trace(files[0])["traceEvents"]}
    # The worker's training steps are in it (a conv forward at least).
    assert any(n and n.startswith("aten::conv") for n in names), sorted(
        n for n in names if n)[:40]
