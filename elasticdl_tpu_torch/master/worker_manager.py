"""Elastic worker lifecycle management.

The TPU-native analog of the reference's pod manager
(elasticdl/python/master/pod_manager.py:207-674): launch workers, watch
their lifecycle events, relaunch failures/preemptions with *fresh* worker
ids, and notify observers (task re-queue, rendezvous refresh).  Backends
plug in under one interface:

 - ProcessWorkerBackend: workers are local subprocesses (tests and
   single-host multi-process jobs).  Preemption drills kill processes.
 - TPU-VM/k8s backends slot in here later with the same event surface.
"""

import os
import signal
import subprocess
import sys
import threading

from elasticdl_tpu_torch.master import worker_state as ws
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class WorkerHandle:
    def __init__(self, worker_id, backend_ref, slot=None):
        self.worker_id = worker_id
        self.backend_ref = backend_ref   # backend-specific (process, pod name)
        # The stable "slot" a worker occupies across relaunches: worker 0
        # dies, worker 4 replaces it, but both fill slot 0 — services and
        # priority classes follow the slot, not the ever-increasing id.
        self.slot = worker_id if slot is None else slot
        self.status = ws.INIT
        self.relaunch_count = 0
        self.relaunch_pending = False


class ProcessWorkerBackend:
    """Workers as local subprocesses of
    `python -m elasticdl_tpu_torch.worker.main`.

    Unlike the JAX package's backend, which defaults every worker to the
    CPU (``JAX_PLATFORMS=cpu``), this one puts no device variable into a
    worker's environment: a worker runs on the card unless
    ``ELASTICDL_TORCH_DEVICE`` is set in the environment it inherits or
    in ``env`` (``ELASTICDL_TORCH_DEVICE=cpu`` for CPU drills)."""

    def __init__(self, worker_args=None, env=None):
        self._worker_args = worker_args or []
        self._env = env or {}

    def launch(self, worker_id, master_addr, slot=None, extra_env=None):
        del slot  # process workers have no service to re-point
        env = dict(os.environ)
        env.update(self._env)
        env.update(extra_env or {})
        env["MASTER_ADDR"] = master_addr
        env["WORKER_ID"] = str(worker_id)
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.worker.main"]
            + list(self._worker_args),
            env=env,
        )
        return proc

    def wait(self, ref):
        return ref.wait()

    def kill(self, ref, force=False):
        try:
            ref.send_signal(signal.SIGKILL if force else signal.SIGTERM)
        except ProcessLookupError:
            pass

    def is_alive(self, ref):
        return ref.poll() is None


class WorkerManager:
    def __init__(
        self,
        backend,
        num_workers,
        max_relaunch_count=3,
        relaunch_on_failure=True,
        cluster_env_fn=None,
    ):
        self._backend = backend
        self._num_workers = num_workers
        self._max_relaunch = max_relaunch_count
        self._relaunch_on_failure = relaunch_on_failure
        # Optional foreign-runtime cluster-spec hook: (worker_id, slot)
        # -> {env} injected into every (re)launch, e.g. a TF_CONFIG
        # built by cluster_spec_env.make_tf_config_fn (reference
        # pod_manager.py:405-422).
        self._cluster_env_fn = cluster_env_fn
        self._master_addr = None
        self._lock = threading.Lock()
        self._workers = {}          # worker_id -> WorkerHandle
        self._next_worker_id = 0
        self._exit_callbacks = []   # fn(worker_id, should_relaunch)
        self._start_callbacks = []  # fn(worker_id)
        self._watchers = []
        self._stopped = threading.Event()
        self._preempted = set()     # worker ids killed by preemption drill
        self._started = False

    # -- wiring -------------------------------------------------------------

    def set_master_addr(self, addr):
        with self._lock:
            self._master_addr = addr

    def add_exit_callback(self, fn):
        self._exit_callbacks.append(fn)

    def add_start_callback(self, fn):
        self._start_callbacks.append(fn)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Launch the initial workers, once: a master that launches them
        before it loads the model spec calls this again in prepare()."""
        with self._lock:
            if self._started:
                return
            self._started = True
        for _ in range(self._num_workers):
            self._launch_worker()

    def _launch_worker(self, slot=None):
        with self._lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            kwargs = {}
            if self._cluster_env_fn is not None:
                kwargs["extra_env"] = self._cluster_env_fn(
                    worker_id, worker_id if slot is None else slot
                )
            ref = self._backend.launch(
                worker_id, self._master_addr, slot=slot, **kwargs
            )
            handle = WorkerHandle(worker_id, ref, slot=slot)
            handle.status = ws.PENDING
            self._workers[worker_id] = handle
        logger.info("launched worker %d", worker_id)
        watcher = threading.Thread(
            target=self._watch_worker, args=(handle,),
            name="worker-watch-%d" % worker_id, daemon=True,
        )
        watcher.start()
        self._watchers.append(watcher)
        for fn in self._start_callbacks:
            fn(worker_id)
        return worker_id

    def _watch_worker(self, handle):
        code = self._backend.wait(handle.backend_ref)
        if self._stopped.is_set():
            return
        with self._lock:
            was_preempted = handle.worker_id in self._preempted
            self._preempted.discard(handle.worker_id)
        if code == 0:
            event = ws.EV_EXIT_0
            handle.status = ws.RUNNING  # exit implies it ran
        elif was_preempted or code in (-signal.SIGTERM, -signal.SIGKILL,
                                       143):
            # 143 = the worker's graceful-preemption exit (it caught
            # SIGTERM, checkpointed, and asked to be relaunched).
            # A raw SIGKILL is ambiguous for local processes: kernel OOM
            # kills and external preemption both yield -9.  We classify it
            # as preemption (the common case on preemptible TPU hosts);
            # the relaunch budget still bounds an OOM crash-loop.
            # Containerized backends report exit 137 and hit EV_OOM below.
            event = ws.EV_PREEMPTED
        elif code == 137:
            event = ws.EV_OOM
        else:
            event = ws.EV_EXIT_ERR
        flow = ws.get_flow(
            handle.status if handle.status != ws.PENDING else ws.RUNNING,
            event,
        )
        if flow is None:
            logger.warning(
                "worker %d: no flow for (%s, %s)",
                handle.worker_id, handle.status, event,
            )
            return
        handle.status = flow.to_status
        should_relaunch = (
            flow.should_relaunch
            and self._relaunch_on_failure
            and handle.relaunch_count < self._max_relaunch
        )
        handle.relaunch_pending = should_relaunch
        logger.info(
            "worker %d exited code=%s event=%s -> %s relaunch=%s",
            handle.worker_id, code, event, handle.status, should_relaunch,
        )
        for fn in self._exit_callbacks:
            fn(handle.worker_id, should_relaunch)
        if should_relaunch and not self._stopped.is_set():
            new_id = self._launch_worker(slot=handle.slot)
            with self._lock:
                self._workers[new_id].relaunch_count = (
                    handle.relaunch_count + 1
                )
        handle.relaunch_pending = False

    # -- control ------------------------------------------------------------

    def preempt_worker(self, worker_id, force=True):
        """Kill a worker as if the platform preempted it (drill hook)."""
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                return False
            self._preempted.add(worker_id)
            # Mark before killing so all_workers_done() can't observe a
            # dead-but-not-yet-relaunched window and abort the job.
            handle.relaunch_pending = True
        self._backend.kill(handle.backend_ref, force=force)
        return True

    def remove_worker(self, worker_id):
        """Master-initiated removal (task-timeout watchdog)."""
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is None:
                return False
            self._preempted.add(worker_id)  # treat as relaunchable
            handle.relaunch_pending = True
        self._backend.kill(handle.backend_ref, force=True)
        return True

    def live_worker_ids(self):
        with self._lock:
            return [
                wid for wid, h in self._workers.items()
                if self._backend.is_alive(h.backend_ref)
            ]

    def all_workers_exited(self):
        with self._lock:
            return all(
                not self._backend.is_alive(h.backend_ref)
                for h in self._workers.values()
            )

    def all_workers_done(self):
        """True when every worker is dead and no relaunch is pending —
        the job cannot make further progress without intervention."""
        with self._lock:
            return all(
                not self._backend.is_alive(h.backend_ref)
                and not h.relaunch_pending
                for h in self._workers.values()
            )

    def stop(self):
        self._stopped.set()
        with self._lock:
            handles = list(self._workers.values())
        for handle in handles:
            if self._backend.is_alive(handle.backend_ref):
                self._backend.kill(handle.backend_ref, force=True)
