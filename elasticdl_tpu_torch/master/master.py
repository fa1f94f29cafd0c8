"""Master orchestrator.

Composes the control-plane components and runs the job to completion
(parity: elasticdl/python/master/master.py:32-135).  The worker manager is
optional — in "wrap your own loop" deployments workers are launched
externally and only the gRPC services run here.
"""

import threading
import time

from elasticdl_tpu_torch.master.servicer import MasterServicer, create_master_service
from elasticdl_tpu_torch.utils import slo
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class Master:
    def __init__(
        self,
        task_manager,
        rendezvous_server=None,
        evaluation_service=None,
        worker_manager=None,
        port=0,
        poll_secs=1.0,
        journal=None,
        interceptors=None,
    ):
        self.task_manager = task_manager
        self.rendezvous_server = rendezvous_server
        self.evaluation_service = evaluation_service
        self.worker_manager = worker_manager
        self._port = port
        self._poll_secs = poll_secs
        self._server = None
        # Crash-restart recovery: the job-state journal (owned by
        # main, threaded into every journaling component) and optional
        # server interceptors (fault injection for drills).
        self.journal = journal
        self._interceptors = interceptors
        self.port = None
        # How managed workers dial back.  None = "localhost:<port>"
        # (process backend).  A k8s master advertises its service DNS
        # name instead; "%d" if present is filled with the bound port.
        self.advertise_addr = None
        self._stop_requested = threading.Event()
        self.servicer = MasterServicer(
            task_manager,
            rendezvous_server=rendezvous_server,
            evaluation_service=evaluation_service,
            worker_manager=worker_manager,
            journal=journal,
        )

    def prepare(self):
        # Elasticity wiring: a dead worker's tasks go back on the queue and
        # the collective world is refreshed (reference
        # pod_event_callbacks.py:80-115).
        if self.worker_manager is not None:
            self.worker_manager.add_exit_callback(self._on_worker_exit)
        self.task_manager.add_worker_timeout_callback(
            self._on_worker_timeout
        )
        self.task_manager.start()
        self._server, self.port = create_master_service(
            self.servicer, port=self._port,
            interceptors=self._interceptors,
        )
        if self.worker_manager is not None:
            addr = self.advertise_addr or "localhost:%d"
            if "%d" in addr:
                addr = addr % self.port
            self.worker_manager.set_master_addr(addr)
            self.worker_manager.start()

    def _on_worker_exit(self, worker_id, should_relaunch):
        self.task_manager.recover_tasks(worker_id)
        if self.rendezvous_server is not None:
            self.rendezvous_server.remove_worker("worker-%d" % worker_id)

    def _on_worker_timeout(self, worker_id):
        if self.worker_manager is not None:
            self.worker_manager.remove_worker(worker_id)
        if self.rendezvous_server is not None:
            self.rendezvous_server.remove_worker("worker-%d" % worker_id)

    def run(self):
        """Block until all tasks are done (and managed workers exited)."""
        stalled_polls = 0
        try:
            while not self._stop_requested.is_set():
                if self.task_manager.finished():
                    if (
                        self.worker_manager is None
                        or self.worker_manager.all_workers_exited()
                    ):
                        counts = self.task_manager.counts()
                        lost = sum(counts["failed"].values())
                        if lost:
                            # Permanently-failed tasks mean dropped data:
                            # the job ran to the end but did not do what
                            # was asked — surface that in the exit code
                            # rather than reporting silent success.
                            logger.error(
                                "job finished with %d permanently "
                                "failed task(s): %s", lost, counts,
                            )
                            return 1
                        logger.info("job finished: %s", counts)
                        break
                elif (
                    self.worker_manager is not None
                    and self.worker_manager.all_workers_done()
                ):
                    # Require consecutive observations: a watcher thread may
                    # not have processed a fresh exit yet (relaunch_pending
                    # is only set once the exit event is handled).
                    stalled_polls += 1
                    if stalled_polls >= 3:
                        logger.error(
                            "all workers failed permanently with tasks "
                            "remaining: %s", self.task_manager.counts(),
                        )
                        return 1
                else:
                    stalled_polls = 0
                # Straggler sweep + SLO evaluation ride the poll
                # cadence (the single-job analog of the multi-tenant
                # ResizeController tick): cross-worker step-time skew
                # is flagged and the default straggler rule can breach
                # without any external scraper driving it.
                if self.servicer is not None:
                    self.servicer.straggler_sweep()
                    if slo.default_watchdog().rule_count:
                        slo.default_watchdog().evaluate()
                time.sleep(self._poll_secs)
        finally:
            self.stop()
        return 0

    def stop(self):
        self._stop_requested.set()
        self.task_manager.stop()
        if self.worker_manager is not None:
            self.worker_manager.stop()
        if self._server is not None:
            self._server.stop(grace=1)
            self._server = None
        if self.journal is not None:
            # Flush any buffered progress events; the journal stays
            # open for late lifecycle appends (close is owned by main).
            self.journal.flush()
