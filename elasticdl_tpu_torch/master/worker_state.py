"""Declarative worker lifecycle state machine.

Parity with the reference's pod state-flow table
(elasticdl/python/master/pod_state.py:28-118): transitions are data, not
code, so backends (local process, k8s/TPU-VM) share one lifecycle and the
relaunch decision is auditable.
"""

from collections import namedtuple

# Worker statuses
INIT = "Init"
PENDING = "Pending"
RUNNING = "Running"
SUCCEEDED = "Succeeded"
FAILED = "Failed"
DELETED = "Deleted"

# Events
EV_LAUNCHED = "launched"
EV_STARTED = "started"
EV_EXIT_0 = "exit_ok"
EV_EXIT_ERR = "exit_err"
EV_PREEMPTED = "preempted"   # external kill (the TPU-preemption analog)
EV_OOM = "oom_killed"        # never relaunched (reference pod_manager.py:102-115)
EV_REMOVED = "removed"       # master-initiated removal (timeout watchdog)

Flow = namedtuple("Flow", ["from_status", "event", "to_status",
                           "should_relaunch"])

STATE_FLOWS = [
    Flow(INIT, EV_LAUNCHED, PENDING, False),
    Flow(PENDING, EV_STARTED, RUNNING, False),
    Flow(PENDING, EV_EXIT_ERR, FAILED, True),
    Flow(PENDING, EV_PREEMPTED, DELETED, True),
    Flow(RUNNING, EV_EXIT_0, SUCCEEDED, False),
    Flow(RUNNING, EV_EXIT_ERR, FAILED, True),
    Flow(RUNNING, EV_PREEMPTED, DELETED, True),
    Flow(RUNNING, EV_OOM, FAILED, False),
    Flow(RUNNING, EV_REMOVED, DELETED, True),
    Flow(PENDING, EV_REMOVED, DELETED, True),
]

_INDEX = {(f.from_status, f.event): f for f in STATE_FLOWS}


def get_flow(from_status, event):
    """Return the matching Flow or None for ignorable transitions."""
    return _INDEX.get((from_status, event))
