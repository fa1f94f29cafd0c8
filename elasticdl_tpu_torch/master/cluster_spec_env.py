"""Foreign-runtime cluster-spec env emission.

The reference's elastic master can host a foreign framework's OWN
distribution protocol by writing a ``TF_CONFIG`` env — the cluster's
worker/ps host list plus this pod's task identity — into every pod it
launches (elasticdl/python/master/pod_manager.py:405-422).  The master
only schedules and relaunches; the foreign runtime speaks its own
protocol between the addresses.

This is that capability as the ~20-line hook PARITY.md promises: build
the env dict here, hand it to ``WorkerManager(cluster_env_fn=...)``,
and every launch (including relaunches) carries it.  The task index is
the worker's stable SLOT, not its ever-increasing worker id, so a
replacement pod inherits the identity its predecessors held — exactly
how the reference keeps a TF cluster spec valid across relaunches
(slot services re-point at the replacement pod).
"""

import json


def tf_config_env(worker_hosts, ps_hosts=None, task_type="worker",
                  task_index=0, chief_hosts=None):
    """{env_name: value} for one task of a TF_CONFIG-shaped cluster."""
    cluster = {"worker": list(worker_hosts)}
    if ps_hosts:
        cluster["ps"] = list(ps_hosts)
    if chief_hosts:
        cluster["chief"] = list(chief_hosts)
    return {
        "TF_CONFIG": json.dumps({
            "cluster": cluster,
            "task": {"type": task_type, "index": int(task_index)},
        })
    }


def make_tf_config_fn(worker_hosts, ps_hosts=None):
    """A ``WorkerManager`` ``cluster_env_fn``: (worker_id, slot) ->
    env.  The slot indexes into ``worker_hosts`` (slot addresses are
    stable across relaunches — k8s slot services, or fixed host:port
    assignments for process workers)."""

    def cluster_env_fn(worker_id, slot):
        del worker_id  # identity follows the slot, not the launch count
        return tf_config_env(
            worker_hosts, ps_hosts=ps_hosts,
            task_type="worker", task_index=slot,
        )

    return cluster_env_fn
