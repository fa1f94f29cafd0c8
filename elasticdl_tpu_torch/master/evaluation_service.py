"""Version-triggered evaluation jobs.

Parity with elasticdl/python/master/evaluation_service.py:21-167: the PS (or
collective trainer) reports model versions; every ``evaluation_steps``
versions the master enqueues evaluation tasks at that version, workers run
forward passes and report (outputs, labels), and the master folds them into
streaming metrics.
"""

import threading

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class EvaluationJob:
    def __init__(self, metrics, model_version, total_tasks):
        self.model_version = model_version
        self._metrics = metrics
        self._total_tasks = total_tasks
        self._completed_tasks = 0

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self):
        return self._completed_tasks >= self._total_tasks

    def report_evaluation_metrics(self, outputs, labels):
        for metric in self._metrics.values():
            metric.update(outputs, labels)

    def results(self):
        return {name: m.result() for name, m in self._metrics.items()}


class EvaluationService:
    def __init__(self, task_manager, metrics_factory, evaluation_steps=0):
        """metrics_factory() -> {name: Metric} builds fresh metrics per job."""
        self._task_manager = task_manager
        self._metrics_factory = metrics_factory
        self._evaluation_steps = evaluation_steps
        self._lock = threading.Lock()
        self._job = None
        self._creating = False
        self._creating_version = -1
        # Reports landing inside the creation window: the tasks become
        # dispatchable the moment create_evaluation_tasks releases the
        # task-manager lock (journal I/O runs outside OUR lock too), so
        # a fast worker can finish one before self._job is assigned.
        # Those completions/metrics are buffered and folded in when the
        # job lands — dropping them would leave the job permanently
        # unfinished and wedge every future evaluation.  Buffering is
        # version-gated: a straggler report from an already-finished
        # job (an RPC retry whose first attempt was processed) must
        # NOT leak into the job being created.
        self._pending_completions = 0
        self._pending_metrics = []
        self._last_eval_version = -1
        self.history = []  # [(model_version, {metric: value})]

    def add_evaluation_task_if_needed(self, model_version):
        if self._evaluation_steps <= 0:
            return False
        with self._lock:
            if self._creating:
                return False
            if (
                model_version // self._evaluation_steps
                <= self._last_eval_version // max(1, self._evaluation_steps)
                and self._last_eval_version >= 0
            ):
                return False
            if self._job is not None and not self._job.finished():
                return False
            # Reserve creation before releasing the lock: task creation
            # journals task records (file I/O that must not run under
            # this lock — EL006), and the reservation keeps a
            # concurrent version report from double-creating the job.
            self._creating = True
            self._creating_version = model_version
            self._pending_completions = 0
            self._pending_metrics = []
        try:
            total = self._task_manager.create_evaluation_tasks(
                model_version
            )
            with self._lock:
                if total == 0:
                    return False
                self._job = EvaluationJob(
                    self._metrics_factory(), model_version, total
                )
                self._last_eval_version = model_version
                for outputs, labels in self._pending_metrics:
                    self._job.report_evaluation_metrics(outputs, labels)
                self._pending_metrics = []
                for _ in range(self._pending_completions):
                    self._complete_one_locked()
                self._pending_completions = 0
            logger.info(
                "evaluation job created at version %d (%d tasks)",
                model_version, total,
            )
            return True
        finally:
            with self._lock:
                self._creating = False

    def report_evaluation_metrics(self, outputs, labels,
                                  model_version=-1):
        """``model_version`` tags the report with the job it belongs
        to (the eval task's version); -1 = unversioned, accepted
        against whatever job is live.  A versioned report that matches
        neither the live job nor the one being created is a straggler
        from a finished job and is dropped."""
        with self._lock:
            if self._job is None:
                if self._creating and self._version_matches_locked(
                    model_version, self._creating_version
                ):
                    self._pending_metrics.append((outputs, labels))
                    return True
                return False
            if not self._version_matches_locked(
                model_version, self._job.model_version
            ):
                return False
            self._job.report_evaluation_metrics(outputs, labels)
            return True

    def complete_task(self, model_version=-1):
        with self._lock:
            if self._job is None:
                if self._creating and self._version_matches_locked(
                    model_version, self._creating_version
                ):
                    self._pending_completions += 1
                return
            if self._version_matches_locked(
                model_version, self._job.model_version
            ):
                self._complete_one_locked()

    @staticmethod
    def _version_matches_locked(model_version, expected):
        return model_version < 0 or model_version == expected

    def _complete_one_locked(self):
        if self._job is None:
            return
        self._job.complete_task()
        if self._job.finished():
            results = self._job.results()
            self.history.append((self._job.model_version, results))
            logger.info(
                "evaluation @ version %d: %s",
                self._job.model_version,
                {k: round(v, 6) for k, v in results.items()},
            )
            # Retire the finished job immediately: if it stayed in
            # self._job, completions/metrics landing in the NEXT job's
            # creation window would be applied to it instead of the
            # pending buffers, leaving the new job one completion
            # short forever — the wedge the buffering exists to
            # prevent.
            self._job = None
