"""The port's twin of tests/test_observability.py: the span API and
flight recorder (``elasticdl_tpu_torch/utils/tracing.py``), gRPC trace
propagation, the /tracez endpoint, telemetry piggybacked on progress
RPCs, Timing snapshot race-safety, Prometheus escaping, process log
identity and the retry policy's trace events, over the port's master,
servicer, status server, worker and serving endpoint.  23 of the
reference's 26 tests: its three EL lint-rule cases check the JAX
package's own lint tool and stay there.  The serving endpoint is asked
for the CPU, as nothing falls back to it on its own.
"""

import json
import os
import threading
import time
import urllib.request

import pytest

from elasticdl_tpu_torch.master.journal import JournalWriter, replay_journal
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
from elasticdl_tpu_torch.master.servicer import (
    MasterServicer,
    create_master_service,
)
from elasticdl_tpu_torch.master.status_server import (
    StatusServer,
    collect_status,
)
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import grpc_utils, tracing
from elasticdl_tpu_torch.utils.prom import prometheus_line, to_prometheus
from elasticdl_tpu_torch.utils.retry import RetryPolicy
from elasticdl_tpu_torch.utils.timing import Timing
from elasticdl_tpu_torch.worker.master_client import MasterClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def create_master(training_shards=None, records_per_task=32, num_epochs=1,
                  rendezvous=False):
    """tests/test_utils.py's, over the port's master."""
    task_manager = TaskManager(training_shards=training_shards,
                               records_per_task=records_per_task,
                               num_epochs=num_epochs)
    master = Master(task_manager, rendezvous_server=(
        RendezvousServer(grace_secs=0.1) if rendezvous else None))
    master.prepare()
    return master


def create_master_client(master, worker_id=0):
    channel = grpc_utils.build_channel("localhost:%d" % master.port)
    grpc_utils.wait_for_channel_ready(channel)
    return MasterClient(channel, worker_id=worker_id)


@pytest.fixture
def clean_tracer():
    """The process-global tracer, ring cleared, attrs restored after —
    in-process tests share it across the 'roles' they simulate."""
    tracer = tracing.default_tracer()
    saved_attrs = tracer.process_attrs
    saved_enabled = tracer.enabled
    tracer.enabled = True
    tracer.recorder.clear()
    yield tracer
    tracer._attrs = saved_attrs
    tracer.enabled = saved_enabled
    tracer.recorder.clear()


def _get(port, path):
    with urllib.request.urlopen(
        "http://127.0.0.1:%d%s" % (port, path), timeout=10
    ) as resp:
        return resp.status, resp.read().decode()


# -- span API / flight recorder ----------------------------------------------

def test_span_nesting_and_context(clean_tracer):
    with tracing.span("outer", kind="test") as outer:
        outer_ctx = tracing.current()
        with tracing.span("inner") as inner:
            assert inner.trace == outer.trace  # one trace
            assert inner.parent == outer.span_id
            tracing.event("marker", x=1)
        assert tracing.current() == outer_ctx
    assert tracing.current() == (None, None)
    events = clean_tracer.recorder.snapshot()
    names = [(e["ph"], e["name"]) for e in events]
    assert names == [("B", "outer"), ("B", "inner"), ("i", "marker"),
                     ("E", "inner"), ("E", "outer")]
    marker = events[2]
    assert marker["trace"] == outer.trace
    assert marker["span"] == inner.span_id


def test_span_error_recorded_and_stack_unwound(clean_tracer):
    with pytest.raises(ValueError):
        with tracing.span("failing"):
            raise ValueError("boom")
    assert tracing.current() == (None, None)
    end = clean_tracer.recorder.snapshot()[-1]
    assert end["ph"] == "E" and "boom" in end["error"]


def test_ring_wraparound_keeps_newest():
    rec = tracing.FlightRecorder(capacity=8)
    for i in range(20):
        rec.record({"n": i})
    events = rec.snapshot()
    assert len(events) == 8
    assert [e["n"] for e in events] == list(range(12, 20))
    assert rec.dropped == 12


def test_disabled_tracer_records_nothing():
    tracer = tracing.Tracer(recorder=tracing.FlightRecorder(16),
                            enabled=False)
    with tracer.span("x") as sp:
        assert sp is None
        tracer.event("y")
    assert len(tracer.recorder) == 0


def test_chrome_export_shapes(clean_tracer):
    with tracing.span("work", step=3):
        tracing.event("tick")
    open_span = clean_tracer.start_span("leaked")
    chrome = tracing.to_chrome(clean_tracer.recorder.snapshot())
    clean_tracer.end_span(open_span)
    rows = {row["name"]: row for row in chrome["traceEvents"]}
    assert rows["work"]["ph"] == "X" and rows["work"]["dur"] >= 0
    assert rows["work"]["args"]["step"] == 3
    assert rows["tick"]["ph"] == "i"
    # unclosed span renders visibly instead of vanishing
    assert rows["leaked"]["ph"] == "i"
    assert rows["leaked"]["args"]["unclosed"] is True


def test_dump_load_roundtrip(tmp_path, clean_tracer):
    clean_tracer.configure(role="testproc")
    with tracing.span("alpha"):
        pass
    path = clean_tracer.dump(str(tmp_path))
    assert path.endswith(".trace.json")
    events = tracing.load_dumps(str(tmp_path))
    assert any(e["name"] == "alpha" for e in events)
    assert all(e["role"] == "testproc" for e in events)


def test_arm_crash_dump_sigterm_still_terminates(tmp_path):
    """A process with the DEFAULT SIGTERM disposition (master, router)
    must still die on SIGTERM after arming the crash dump — the
    handler dumps the ring, restores SIG_DFL, and re-delivers; and the
    dump must actually land."""
    import signal
    import subprocess
    import sys

    code = (
        "import os, signal, time\n"
        "from elasticdl_tpu_torch.utils import tracing\n"
        "tracing.configure(role='master')\n"
        "tracing.arm_crash_dump()\n"
        "tracing.event('alive')\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(30)\n"           # must never be reached
        "print('SURVIVED')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, ELASTICDL_TRACE_DIR=str(tmp_path),
                 PYTHONPATH=os.pathsep.join(
                     [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p])),
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == -signal.SIGTERM
    assert "SURVIVED" not in proc.stdout
    events = tracing.load_dumps(str(tmp_path))
    assert any(e["name"] == "sigterm" for e in events)


def test_trace_components_link_trace_merges():
    events = [
        {"trace": "a", "name": "x"},
        {"trace": "b", "name": "y", "link_trace": "a"},
        {"trace": "c", "name": "z"},
    ]
    comps = tracing.trace_components(events)
    assert sorted(len(c) for c in comps) == [1, 2]
    linked = next(c for c in comps if len(c) == 2)
    assert {e["name"] for e in linked} == {"x", "y"}


# -- gRPC propagation through a real channel ---------------------------------

def test_span_propagates_through_real_grpc_channel(clean_tracer):
    master = create_master(training_shards=[("f", 0, 64)],
                           records_per_task=32)
    mc = create_master_client(master)
    try:
        with tracing.span("worker.task", task=0) as task_span:
            task = mc.get_task()
            assert task.id >= 0
            mc.report_task_result(task.id)
        events = clean_tracer.recorder.snapshot()
        # client span, server span, and the master's task.completed
        # breadcrumb all share the task span's trace
        client = [e for e in events if e["ph"] == "B"
                  and e["name"] == "rpc.client/report_task_result"]
        server = [e for e in events if e["ph"] == "B" and e["name"]
                  .startswith("rpc.server/")
                  and e["name"].endswith("report_task_result")]
        done = [e for e in events if e["name"] == "task.completed"]
        assert client and server and done
        assert client[0]["trace"] == task_span.trace
        assert server[0]["trace"] == task_span.trace
        assert server[0]["parent"] == client[0]["span"]
        assert done[0]["trace"] == task_span.trace
    finally:
        master.stop()


def test_inject_extract_roundtrip(clean_tracer):
    assert tracing.inject(None) is None  # no open span: no metadata
    with tracing.span("ctx") as sp:
        md = tracing.inject([("other", "kept")])
        trace, parent = tracing.Tracer.extract(md)
        assert trace == sp.trace and parent == sp.span_id
        assert ("other", "kept") in md


# -- the connected-trace recovery assertion (in-process master kill) ---------

def test_master_restart_yields_one_connected_trace(tmp_path,
                                                   clean_tracer):
    """The cpu_master_kill drill's trace gate, in miniature and
    in-process: worker trace (kill-window retries + post-recovery task
    completion) and the restarted master's journal-replay trace form
    ONE component via the link_trace stamp."""
    jdir = str(tmp_path)
    port = grpc_utils.find_free_port()

    tm1 = TaskManager(training_shards=[("f", 0, 96)],
                      records_per_task=32, num_epochs=1)
    tm1.attach_journal(JournalWriter(jdir), bootstrap=True)
    servicer1 = MasterServicer(tm1)
    server1, _ = create_master_service(servicer1, port=port)

    channel = grpc_utils.build_channel("localhost:%d" % port)
    grpc_utils.wait_for_channel_ready(channel)
    mc = MasterClient(
        channel, worker_id=0, addr="localhost:%d" % port,
        retry=RetryPolicy(name="test_mc", deadline_secs=30.0,
                          base_delay_secs=0.05, max_delay_secs=0.2),
    )

    with tracing.span("worker.run", worker=0):
        with tracing.span("worker.task"):
            task = mc.get_task()
            mc.report_task_result(task.id)

        # "kill" the master; the journal survives.  Wait for the stop
        # to complete — the listener must actually release the port
        # before the in-process restart can rebind it.
        server1.stop(grace=0).wait(timeout=10)

        # restart flow as master/main.py runs it: replay under a span,
        # then stamp every later master event with the link back
        with tracing.span("master.journal_replay") as replay_span:
            state = replay_journal(jdir)
            tracing.event("journal.replayed", restarts=state.restarts)
        clean_tracer.configure(restart=state.restarts + 1,
                               link_trace=replay_span.trace)

        restart_done = threading.Event()
        restart_errors = []
        # keep the restarted server referenced past the thread's exit
        # (a dropped grpc.Server is GC'd and its listener closes)
        restarted = {}

        def restart_master():
            try:
                # small outage window so the worker's retry fires
                time.sleep(0.4)
                tm2 = TaskManager(training_shards=[("f", 0, 96)],
                                  records_per_task=32, num_epochs=1)
                tm2.restore_from_journal(state)
                writer = JournalWriter(jdir)
                writer.append({"ev": "restart"})
                tm2.attach_journal(writer, bootstrap=False)
                servicer2 = MasterServicer(tm2)
                servicer2.restore_from_journal(state)
                # same-port rebind can race the old listener's
                # teardown in-process: add_insecure_port returns 0 on
                # failure, so retry until the port is really ours
                bound = 0
                for _ in range(100):
                    server2, bound = create_master_service(
                        servicer2, port=port)
                    if bound == port:
                        restarted["server"] = server2
                        break
                    server2.stop(grace=0)
                    time.sleep(0.1)
                assert bound == port, "could not rebind port"
                restart_done.set()
            except Exception as e:  # noqa: BLE001 — surfaced below
                import traceback
                restart_errors.append(
                    "%s\n%s" % (e, traceback.format_exc()))

        t = threading.Thread(target=restart_master, daemon=True)
        t.start()
        # outage-riding: this fetch retries through the dead window
        # and lands on master #2 (post-recovery task completion)
        with tracing.span("worker.task"):
            task = mc.get_task()
            assert task.id >= 0
            mc.report_task_result(task.id)
        t.join(timeout=30)
        assert not restart_errors, restart_errors
        assert restart_done.is_set()
    restarted["server"].stop(grace=0)

    events = clean_tracer.recorder.snapshot()
    comps = tracing.trace_components(events)
    incident = comps[0]  # largest component
    names = {e["name"] for e in incident}
    # kill evidence, recovery evidence, and the first post-recovery
    # completion — all in ONE connected component
    assert "rpc_retry" in names
    assert "journal.replayed" in names
    assert "task.completed" in names
    # and the completion happened on the RESTARTED incarnation
    completions = [e for e in incident if e["name"] == "task.completed"]
    assert any(e.get("restart") == 1 for e in completions)


# -- /tracez + concurrent-mutation hammers -----------------------------------

def test_status_endpoints_under_concurrent_mutation(clean_tracer):
    master = create_master(training_shards=[("f", 0, 4096)],
                           records_per_task=16, rendezvous=True)
    server = StatusServer(
        master.task_manager,
        rendezvous_server=master.rendezvous_server,
        servicer=master.servicer,
        host="127.0.0.1",
    )
    server.start()
    stop = threading.Event()
    errors = []

    def mutate():
        mc = create_master_client(master)
        i = 0
        try:
            while not stop.is_set():
                i += 1
                req = pb.ReportBatchDoneRequest(
                    worker_id=i % 4, record_count=16,
                    steps_per_sec=float(i), sync_fraction=0.5,
                    steps_done=i,
                )
                master.servicer.report_batch_done(req)
                with tracing.span("hammer", i=i):
                    tracing.event("tick-%d" % (i % 7))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=mutate, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 2.0
        while time.time() < deadline:
            for path in ("/status", "/metrics", "/tracez",
                         "/tracez?fmt=chrome"):
                code, body = _get(server.port, path)
                assert code == 200
                if path == "/status":
                    status = json.loads(body)
                    if "telemetry" in status:
                        assert status["telemetry"]["job"][
                            "workers_reporting"] >= 1
                elif path.startswith("/tracez"):
                    json.loads(body)  # parseable mid-hammer
                else:
                    assert "elasticdl_tasks_todo" in body
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        server.stop()
        master.stop()
    assert not errors


def test_serving_statz_metrics_tracez_under_load(tmp_path,
                                                 clean_tracer):
    """The serving replica's observability surface under concurrent
    predict traffic: /statz, /metrics, and /tracez all answer
    parseable 200s while request threads mutate the Timing stats and
    the flight recorder."""
    import http.client

    from elasticdl_tpu_torch.serving.batcher import BatchConfig
    from elasticdl_tpu_torch.serving.server import (
        ModelEndpoint,
        build_server as build_serving_server,
    )
    from tests.test_torch_serving_batcher import _linear_export

    _linear_export(tmp_path / "e")
    endpoint = ModelEndpoint(
        str(tmp_path / "e"), device="cpu",
        batching=BatchConfig(max_batch_size=4, batch_timeout_ms=2.0,
                             warm=True))
    server = build_serving_server(endpoint, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    stop = threading.Event()
    errors = []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=30)
        try:
            k = 0
            while not stop.is_set():
                k += 1
                with tracing.span("client.predict", k=k):
                    conn.request(
                        "POST", "/v1/models/lin:predict",
                        body=json.dumps({"instances": [[k, 0, 0, 0]]}))
                    assert conn.getresponse().read()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        deadline = time.time() + 2.0
        while time.time() < deadline:
            for path in ("/statz", "/metrics", "/tracez",
                         "/tracez?fmt=chrome"):
                code, body = _get(port, path)
                assert code == 200
                if path == "/statz":
                    json.loads(body)
                elif path.startswith("/tracez"):
                    json.loads(body)
                else:
                    assert "elasticdl_serving_requests" in body
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        server.shutdown()
        server.server_close()
        endpoint.close()
    assert not errors


def test_tracez_endpoint_payload(clean_tracer):
    clean_tracer.configure(role="master")
    with tracing.span("visible"):
        pass
    master = create_master(training_shards=[("f", 0, 32)],
                           records_per_task=32)
    server = StatusServer(master.task_manager, host="127.0.0.1")
    server.start()
    try:
        code, body = _get(server.port, "/tracez")
        payload = json.loads(body)
        assert code == 200
        assert payload["process"]["role"] == "master"
        assert any(e["name"] == "visible"
                   for e in payload["events"])
        code, body = _get(server.port, "/tracez?fmt=chrome")
        chrome = json.loads(body)
        assert any(row["name"] == "visible"
                   for row in chrome["traceEvents"])
    finally:
        server.stop()
        master.stop()


# -- telemetry piggyback ------------------------------------------------------

def test_telemetry_rides_progress_rpc_end_to_end(clean_tracer):
    master = create_master(training_shards=[("f", 0, 64)],
                           records_per_task=32)
    mc = create_master_client(master, worker_id=3)
    try:
        mc.report_batch_done(32, telemetry={
            "steps_per_sec": 12.5, "sync_fraction": 0.125,
            "push_staleness": 2.0, "window_size": 4.0,
            "steps_done": 40,
        })
        telemetry = master.servicer.telemetry()
        worker = telemetry["workers"][3]
        assert worker["steps_per_sec"] == 12.5
        assert worker["sync_fraction"] == 0.125
        assert worker["push_staleness"] == 2.0
        assert worker["window_size"] == 4.0
        assert worker["steps_done"] == 40
        assert worker["age_secs"] < 10
        assert telemetry["job"]["steps_per_sec"] == 12.5
        assert telemetry["job"]["workers_reporting"] == 1

        # a second worker sums into the job aggregate
        mc2 = create_master_client(master, worker_id=4)
        mc2.report_batch_done(32, telemetry={
            "steps_per_sec": 7.5, "steps_done": 8})
        assert master.servicer.telemetry()["job"][
            "steps_per_sec"] == 20.0

        status = collect_status(master.task_manager,
                                servicer=master.servicer)
        text = to_prometheus(status)
        assert "elasticdl_job_steps_per_sec" in text
        assert 'elasticdl_worker_steps_per_sec{worker="3"} 12.5' in text

        # stale workers (> 60 s) fall out of the aggregate AND out of
        # /metrics (a scraper must not sum a dead worker's last rate)
        # but stay visible in /status JSON with their age
        stale = master.servicer.telemetry(now=time.time() + 300)
        assert stale["job"]["workers_reporting"] == 0
        assert stale["job"]["steps_per_sec"] == 0.0
        assert 3 in stale["workers"]
        assert stale["workers"][3]["fresh"] is False
        stale_text = to_prometheus(
            {"tasks": status["tasks"], "finished": status["finished"],
             "telemetry": stale})
        assert "elasticdl_worker_steps_per_sec" not in stale_text
        assert "elasticdl_telemetry_workers_reporting 0" in stale_text

        # long-dead workers (> 15 min) are EVICTED outright: the dict
        # and the /status payload stay bounded over elastic churn
        evicted = master.servicer.telemetry(now=time.time() + 3600)
        assert evicted["workers"] == {}
        assert master.servicer.telemetry()["workers"] == {}
    finally:
        master.stop()


def test_telemetry_absent_without_steps(clean_tracer):
    master = create_master(training_shards=[("f", 0, 64)],
                           records_per_task=32)
    mc = create_master_client(master, worker_id=0)
    try:
        mc.report_batch_done(32)  # legacy form: no telemetry fields
        assert master.servicer.telemetry()["workers"] == {}
        status = collect_status(master.task_manager,
                                servicer=master.servicer)
        assert "telemetry" not in status
    finally:
        master.stop()


def test_shard_service_telemetry_fn_feeds_reports(clean_tracer):
    from elasticdl_tpu_torch.worker.data_shard_service import DataShardService

    master = create_master(training_shards=[("f", 0, 32)],
                           records_per_task=32)
    mc = create_master_client(master, worker_id=7)
    try:
        calls = []

        def telemetry_fn():
            calls.append(1)
            return {"steps_per_sec": 3.0, "steps_done": len(calls)}

        ds = DataShardService(mc, batch_size=32,
                              telemetry_fn=telemetry_fn)
        task = ds.fetch_task()
        ds.report_batch_done()  # drains the shard -> flush + done
        assert task is not None and calls
        assert master.servicer.worker_telemetry[7][
            "steps_per_sec"] == 3.0
    finally:
        master.stop()


def test_worker_telemetry_snapshot_shapes():
    """Worker._telemetry_snapshot: steps/s over the mark interval,
    sync fraction from Timing, staleness from the trainer hook."""
    from elasticdl_tpu_torch.worker.worker import Worker

    class _Trainer:
        def push_staleness(self):
            return 2.0

    worker = Worker.__new__(Worker)
    worker._trainer = _Trainer()
    worker.timing = Timing()
    worker._steps = 0
    worker._tele_mark = (None, 0)
    first = worker._telemetry_snapshot()
    assert first["steps_done"] == 0
    assert "steps_per_sec" not in first  # no interval yet
    worker._steps = 50
    worker._tele_mark = (time.monotonic() - 2.0, 0)
    worker.timing.observe("window_dispatch", 3.0)
    worker.timing.observe("loss_sync", 1.0)
    worker.timing.bump("fused_windows", 10)
    worker.timing.bump("fused_steps_run", 40)
    snap = worker._telemetry_snapshot()
    assert 20.0 <= snap["steps_per_sec"] <= 30.0
    assert snap["sync_fraction"] == 0.25
    assert snap["push_staleness"] == 2.0
    assert snap["window_size"] == 4.0
    assert snap["steps_done"] == 50


# -- Timing snapshot race-safety ---------------------------------------------

class _ListLogger:
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(fmt % args if args else fmt)


def test_timing_snapshot_hammer():
    """Writers minting NEW phase/counter names nonstop while every
    snapshot path runs concurrently: no 'dict changed size' blowups,
    and the final counts are exact."""
    timing = Timing(logger=_ListLogger())
    stop = threading.Event()
    errors = []
    WRITERS, PER_WRITER = 4, 400

    def write(seed):
        try:
            for i in range(PER_WRITER):
                timing.bump("shared")
                timing.bump("w%d-ev%d" % (seed, i))
                timing.observe("w%d-phase%d" % (seed, i), 0.001)
                with timing.timeit("w%d-timed%d" % (seed, i % 17)):
                    pass
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                timing.summary()
                timing.counters()
                timing.report()
                timing.sync_fraction("a", "b")
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    readers = [threading.Thread(target=read, daemon=True)
               for _ in range(2)]
    writers = [threading.Thread(target=write, args=(s,), daemon=True)
               for s in range(WRITERS)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=10)
    assert not errors
    assert timing.counters()["shared"] == WRITERS * PER_WRITER
    summary = timing.summary()
    assert summary["w0-phase0"]["count"] == 1


# -- prom escaping ------------------------------------------------------------

def test_prometheus_label_escaping():
    line = prometheus_line("m", 1, path='C:\\dir "x"\nnext')
    assert line == 'm{path="C:\\\\dir \\"x\\"\\nnext"} 1'
    assert prometheus_line("m", 2) == "m 2"
    # sorted label order, multiple labels
    line = prometheus_line("m", 3, b="2", a="1")
    assert line == 'm{a="1",b="2"} 3'


def test_status_server_reexports_renderers():
    # historical import path keeps working after the utils/prom move
    from elasticdl_tpu_torch.master import status_server
    from elasticdl_tpu_torch.utils import prom

    assert status_server.to_prometheus is prom.to_prometheus
    assert status_server.prometheus_line is prom.prometheus_line
    assert status_server.serving_to_prometheus is (
        prom.serving_to_prometheus)
    assert status_server.fleet_to_prometheus is prom.fleet_to_prometheus


# -- process log identity -----------------------------------------------------

def test_log_identity_prefix():
    import logging as _logging

    from elasticdl_tpu_torch.utils.logging import (
        _IdentityFormatter,
        get_process_identity,
        set_process_identity,
    )

    saved = get_process_identity()
    try:
        set_process_identity("ps", rank=1, generation=2)
        fmt = _IdentityFormatter("%(identity)s%(message)s")
        record = _logging.LogRecord("n", _logging.INFO, "p", 1,
                                    "hello", (), None)
        assert fmt.format(record) == "[ps-1@g2] hello"
        set_process_identity("worker", rank=0)
        assert fmt.format(record) == "[worker-0] hello"
    finally:
        # restore whatever identity the test process had
        from elasticdl_tpu_torch.utils.logging import _identity
        _identity["label"] = saved


# -- retry events -------------------------------------------------------------

def test_retry_policy_records_trace_events(clean_tracer):
    calls = {"n": 0}

    class _Transient(Exception):
        pass

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise _Transient("nope")
        return "ok"

    policy = RetryPolicy(
        name="test", max_attempts=5, deadline_secs=None,
        base_delay_secs=0.0, jitter=0.0,
        retryable=lambda e: isinstance(e, _Transient),
        sleep=lambda _s: None,
    )
    with tracing.span("owner") as sp:
        assert policy.call(flaky, description="flaky") == "ok"
    retries = [e for e in clean_tracer.recorder.snapshot()
               if e["name"] == "rpc_retry"]
    assert len(retries) == 2
    # inherited the caller's context: the outage evidence lands in the
    # owning span's trace
    assert all(e["trace"] == sp.trace for e in retries)
