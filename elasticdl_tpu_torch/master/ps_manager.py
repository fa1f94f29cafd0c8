"""Parameter-server process lifecycle.

The master launches/watches/relaunches PS shards the way it does workers
(reference: PS pods in pod_manager, protected by priority; relaunch uses
``checkpoint_dir_for_init`` so a fresh shard restores its hash-routed slice
of the newest COMMITTED cross-shard checkpoint — go/pkg/ps/checkpoint.go
semantics, barrier semantics in docs/ps_recovery.md).  Each launch passes
a ``--generation`` hint (this manager's per-shard launch count) so a
relaunched shard serves as a strictly newer restart generation even when
its checkpoint dir — where the generation normally persists — was lost
with the pod.

The relaunch budget DECAYS: a shard that stayed healthy for
``relaunch_decay_secs`` before dying gets its count reset, so a long job
surviving occasional preemptions never exhausts ``max_relaunch`` forever
— the budget bounds crash *loops*, not total preemptions.  ``stop()``
escalates terminate→kill with a bounded wait so a wedged shard cannot
hang teardown.
"""

import os
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.utils.grpc_utils import find_free_port
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PSManager:
    # A shard that survives this long is considered to have exited its
    # crash loop: the next death starts a fresh relaunch budget.
    DEFAULT_RELAUNCH_DECAY_SECS = 300.0
    # stop(): grace between SIGTERM and SIGKILL, and the bounded wait
    # after SIGKILL (a kill can only be outwaited by a kernel wedge).
    STOP_GRACE_SECS = 5.0
    STOP_KILL_WAIT_SECS = 5.0

    def __init__(self, num_ps, opt_type, opt_args, master_addr="",
                 checkpoint_dir="", checkpoint_steps=0,
                 evaluation_steps=0, use_async=True, grads_to_wait=1,
                 sync_version_tolerance=0, max_relaunch=5,
                 relaunch_decay_secs=None, ps_fault_spec=""):
        self.num_ps = num_ps
        self._opt_type = opt_type
        self._opt_args = opt_args
        self._master_addr = master_addr
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_steps = checkpoint_steps
        self._evaluation_steps = evaluation_steps
        self._use_async = use_async
        self._grads_to_wait = grads_to_wait
        self._sync_version_tolerance = sync_version_tolerance
        self._max_relaunch = max_relaunch
        self._relaunch_decay_secs = (
            self.DEFAULT_RELAUNCH_DECAY_SECS
            if relaunch_decay_secs is None else float(relaunch_decay_secs)
        )
        # Deterministic worker->PS fault drills: forwarded to every
        # shard as its --rpc_fault_spec (docs/master_recovery.md
        # grammar; the cpu_ps_kill drill leans on this).
        self._ps_fault_spec = ps_fault_spec
        self.ports = [find_free_port() for _ in range(num_ps)]
        self._procs = {}
        self._relaunches = {}
        self._launch_counts = {}   # ps_id -> total launches (gen hint)
        self._launched_at = {}     # ps_id -> monotonic launch time
        self._stopped = threading.Event()
        self._lock = threading.Lock()

    @property
    def addrs(self):
        return ",".join("localhost:%d" % p for p in self.ports)

    def _args(self, ps_id, restore, generation):
        args = [
            "--port", str(self.ports[ps_id]),
            "--ps_id", str(ps_id),
            "--num_ps", str(self.num_ps),
            "--opt_type", self._opt_type,
            "--opt_args", self._opt_args,
            "--use_async", str(self._use_async),
            "--grads_to_wait", str(self._grads_to_wait),
            "--sync_version_tolerance", str(self._sync_version_tolerance),
            "--evaluation_steps", str(self._evaluation_steps),
            # Restart-generation hint: the shard serves as
            # max(persisted+1, hint) so relaunches fence even when the
            # persisted counter vanished with the pod's disk.
            "--generation", str(generation),
        ]
        if self._master_addr:
            args += ["--master_addr", self._master_addr]
        if self._ps_fault_spec:
            args += ["--rpc_fault_spec", self._ps_fault_spec]
        if self._checkpoint_dir:
            args += [
                "--checkpoint_dir", self._checkpoint_dir,
                "--checkpoint_steps", str(self._checkpoint_steps),
            ]
            if restore:
                args += ["--checkpoint_dir_for_init",
                         self._checkpoint_dir]
        return args

    def _launch(self, ps_id, restore=False):
        env = dict(os.environ)
        env.setdefault("JAX_PLATFORMS", "cpu")
        with self._lock:
            if self._stopped.is_set():
                return
            count = self._launch_counts.get(ps_id, 0) + 1
            self._launch_counts[ps_id] = count
            proc = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.ps.server"]
                + self._args(ps_id, restore, count),
                env=env,
            )
            self._procs[ps_id] = proc
            self._launched_at[ps_id] = time.monotonic()
        logger.info("launched PS %d on port %d (restore=%s, "
                    "generation hint %d)",
                    ps_id, self.ports[ps_id], restore, count)
        threading.Thread(
            target=self._watch, args=(ps_id, proc),
            name="ps-watch-%d" % ps_id, daemon=True,
        ).start()

    def _watch(self, ps_id, proc):
        code = proc.wait()
        if self._stopped.is_set():
            return
        with self._lock:
            launched = self._launched_at.get(ps_id, 0.0)
        uptime = time.monotonic() - launched
        count = self._relaunches.get(ps_id, 0)
        if count and uptime >= self._relaunch_decay_secs:
            # The shard rode out its previous trouble and served
            # healthily for a sustained window: this death opens a
            # fresh budget instead of inching toward permanent death
            # on a long job's occasional preemptions.
            logger.info(
                "PS %d was healthy %.0fs (>= %.0fs): relaunch budget "
                "reset (%d -> 0)", ps_id, uptime,
                self._relaunch_decay_secs, count,
            )
            count = 0
        if count >= self._max_relaunch:
            logger.error("PS %d died (code %s); relaunch budget spent",
                         ps_id, code)
            return
        self._relaunches[ps_id] = count + 1
        logger.warning("PS %d died (code %s); relaunching with restore",
                       ps_id, code)
        self._launch(ps_id, restore=bool(self._checkpoint_dir))

    def start(self):
        for ps_id in range(self.num_ps):
            self._launch(ps_id)

    def stop(self):
        # Flag first under the lock so no in-flight _watch relaunch can
        # spawn an orphan after we start terminating.
        with self._lock:
            self._stopped.set()
            procs = list(self._procs.values())
        live = [p for p in procs if p.poll() is None]
        for proc in live:
            proc.terminate()
        # Bounded escalation: give the fleet one shared grace window,
        # then SIGKILL stragglers — a shard wedged mid-checkpoint (or
        # with a stuck gRPC thread) must not hang job teardown.
        deadline = time.monotonic() + self.STOP_GRACE_SECS
        for proc in live:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                logger.warning(
                    "PS pid %d ignored SIGTERM for %.0fs; killing",
                    proc.pid, self.STOP_GRACE_SECS,
                )
                proc.kill()
        deadline = time.monotonic() + self.STOP_KILL_WAIT_SECS
        for proc in live:
            if proc.poll() is None:
                try:
                    proc.wait(
                        timeout=max(0.0, deadline - time.monotonic())
                    )
                except subprocess.TimeoutExpired:
                    logger.error("PS pid %d survived SIGKILL wait; "
                                 "abandoning reap", proc.pid)
