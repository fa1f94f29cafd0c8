"""Standalone job monitor (parity:
elasticdl/python/common/k8s_job_monitor.py:32-100): polls a running
master's control plane and summarizes job health without joining it."""

import time

from elasticdl_tpu_torch.proto import elastic_pb2 as pb
from elasticdl_tpu_torch.utils import grpc_utils
from elasticdl_tpu_torch.utils.logging import get_logger
from elasticdl_tpu_torch.utils.retry import RetryPolicy
from elasticdl_tpu_torch.worker.master_client import MasterClient

logger = get_logger(__name__)


class JobMonitor:
    def __init__(self, master_addr, poll_secs=10):
        channel = grpc_utils.build_channel(master_addr)
        # FAIL-FAST policy, not the 120 s outage-riding default: this
        # client's job is to DETECT an unreachable master — riding the
        # outage would stall every probe for the full retry budget and
        # stretch watch()'s unreachability verdict by minutes.
        self._mc = MasterClient(
            channel, worker_id=-2,
            retry=RetryPolicy(
                name="job_monitor", max_attempts=2,
                deadline_secs=2.0, base_delay_secs=0.2,
                max_delay_secs=0.5,
            ),
        )
        self._poll_secs = poll_secs

    def snapshot(self):
        """One health probe: can the master be reached, what world is
        committed, is work still being dispatched."""
        out = {"reachable": False}
        try:
            rank = self._mc.get_comm_rank()
            out["reachable"] = True
            out["world_size"] = rank.world_size
            out["rendezvous_id"] = rank.rendezvous_id
            task = self._mc.get_task(pb.EVALUATION)
            # monitors only peek: hand real work straight back via the
            # explicit requeue field so the probe never consumes a retry
            # or counts as completion
            if task.id > 0:
                self._mc.report_task_result(
                    task.id, err_message="job-monitor probe",
                    requeue=True,
                )
            out["dispatching"] = task.id > 0 or task.type == pb.WAIT
        except Exception as e:  # noqa: BLE001
            out["error"] = str(e)
        return out

    def watch(self, until_unreachable_polls=3):
        misses = 0
        while misses < until_unreachable_polls:
            snap = self.snapshot()
            logger.info("job status: %s", snap)
            misses = 0 if snap["reachable"] else misses + 1
            time.sleep(self._poll_secs)
        logger.info("master unreachable; job presumed finished")
