"""Kubernetes worker backend (counterpart of
``elasticdl_tpu/master/k8s_backend.py``).

Plugs into WorkerManager behind the same launch/wait/kill/is_alive surface
as ProcessWorkerBackend (parity with the reference's pod manager + k8s
client, elasticdl/python/master/pod_manager.py:207-674 and
common/k8s_client.py:41-334).  Everything cluster-specific stays in this
one module so the rest of the control plane is backend-agnostic.

Manifests are plain dicts (the k8s API accepts them directly), so the
backend is unit-testable against a fake API object with no ``kubernetes``
package in the image — pass ``core_api=`` to inject one; the default
constructor imports the real client and loads in-cluster/kubeconfig
credentials.

Reference behaviors carried over:
 - pod labels job-name / replica-type / replica-index
   (elasticdl_client/common/k8s_client.py:29-32);
 - a service per worker, patched to select the replacement pod when a
   worker is relaunched under a fresh id
   (common/k8s_client.py:261-274) — so PS/master addressing of a worker
   slot survives relaunches;
 - high/low worker pod priority split: the first
   ``ceil(fraction * num_workers)`` workers get the high priority class
   (pod_manager.py:80-99), protecting a core of the fleet from
   preemption;
 - a pluggable cluster-spec hook: a dotted module path exporting
   ``patch_pod(manifest) -> manifest`` / ``patch_service(manifest) ->
   manifest`` applied before every create, for site-specific tweaks
   (elasticdl_client/common/k8s_client.py:106-218).

Preemption shows up as pod DELETED/gone states, which ``wait`` maps to
the same EV_PREEMPTED flow the process backend uses — so preemption on
the cluster and local kill -9 drills exercise one code path.

Where a GPU worker pod differs from the reference's TPU one:
 - the container runs ``python -m elasticdl_tpu_torch.worker.main``;
 - an extended resource (any key but ``cpu``, ``memory`` and
   ``ephemeral-storage``, e.g. ``nvidia.com/gpu``) goes under ``limits``
   as well as ``requests``, with the same value: Kubernetes does not
   overcommit extended resources, and its API server refuses a container
   that requests one without the same limit;
 - ``tpu_topology`` (``--tpu_topology``) raises ``ValueError``: the
   reference's GKE TPU ``nodeSelector`` would schedule a GPU pod nowhere.
   The parser keeps the flag, so both packages take the same argv.
"""

import importlib
import math
import threading

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LABEL_JOB = "elasticdl-tpu-job-name"
LABEL_TYPE = "replica-type"
LABEL_INDEX = "replica-index"

# Resources the scheduler may overcommit (requests below limits); any
# other key is an extended resource, whose request must equal its limit.
OVERCOMMITTABLE = ("cpu", "memory", "ephemeral-storage")


def container_resources(resources):
    """A container's ``resources``: every entry under ``requests``, and
    each extended resource (``nvidia.com/gpu``) under ``limits`` too."""
    out = {"requests": dict(resources)}
    limits = {k: v for k, v in resources.items()
              if k not in OVERCOMMITTABLE}
    if limits:
        out["limits"] = limits
    return out


def owner_ref_from_env(environ=None):
    """The master pod's own identity (downward-API env POD_NAME /
    POD_UID, injected by the client's submit manifest) as an
    ownerReference dict — or None outside a cluster."""
    import os

    environ = os.environ if environ is None else environ
    name, uid = environ.get("POD_NAME"), environ.get("POD_UID")
    if not name or not uid:
        return None
    return {"name": name, "uid": uid}


def load_cluster_spec(path):
    """Import a cluster-spec module ('pkg.mod') exporting optional
    patch_pod / patch_service hooks."""
    if not path:
        return None
    return importlib.import_module(path)


def apply_spec_hook(spec_mod, manifest, hook_name):
    """Run a cluster-spec patch hook over a manifest dict (shared by
    the worker backend and the client submit path)."""
    hook = getattr(spec_mod, hook_name, None) if spec_mod else None
    if hook is not None:
        patched = hook(manifest)
        if patched is not None:
            return patched
    return manifest


def default_core_api():
    """Real kubernetes CoreV1Api with in-cluster-else-kubeconfig
    credentials (the one bootstrap both the backend and the client
    submit path share)."""
    try:
        from kubernetes import client, config
    except ImportError as e:
        raise ImportError(
            "this path needs the `kubernetes` package; install it in "
            "the cluster image (locally, use the process backend or "
            "--output manifest rendering)"
        ) from e
    try:
        config.load_incluster_config()
    except Exception:
        config.load_kube_config()
    return client.CoreV1Api()


class K8sWorkerBackend:
    def __init__(self, job_name, image, namespace="default",
                 worker_args=None, resources=None, tpu_topology=None,
                 num_workers=0, high_priority_fraction=0.0,
                 priority_class_high="high-priority",
                 priority_class_low="", cluster_spec="",
                 core_api=None, poll_secs=5.0, owner_ref=None,
                 volume=""):
        if tpu_topology:
            raise ValueError(
                "--tpu_topology %r selects GKE TPU nodes, which a GPU "
                "worker pod cannot run on; leave it unset and request "
                "the card with --worker_resource_request "
                "nvidia.com/gpu=1" % (tpu_topology,))
        # None = build the real client lazily on first API call, so the
        # master can construct the backend (flag parsing, manifests)
        # before cluster credentials are needed.
        self._core_api = core_api
        self._job_name = job_name
        self._image = image
        self._namespace = namespace
        self._worker_args = worker_args or []
        self._resources = resources or {}
        self._num_workers = num_workers
        self._high_fraction = high_priority_fraction
        self._priority_high = priority_class_high
        self._priority_low = priority_class_low
        self._cluster_spec = (
            load_cluster_spec(cluster_spec)
            if isinstance(cluster_spec, str) else cluster_spec
        )
        self._poll_secs = poll_secs
        # Master pod identity: stamped as ownerReference on every worker
        # pod/service, so deleting the master cascades the job (the
        # reference's ownership model, common/k8s_client.py:354-357).
        self._owner_ref = owner_ref
        from elasticdl_tpu_torch.client.k8s_renderer import parse_volume_string

        # --volume mounts (reference k8s_volume.py semantics): applied
        # to every worker pod this backend launches.
        self._volumes, self._volume_mounts = parse_volume_string(volume)
        self._exit_events = {}  # pod name -> threading.Event w/ .code

    @property
    def _core(self):
        if self._core_api is None:
            self._core_api = default_core_api()
        return self._core_api

    @_core.setter
    def _core(self, api):
        self._core_api = api

    def _pod_name(self, worker_id):
        return "%s-worker-%d" % (self._job_name, worker_id)

    def _service_name(self, worker_id):
        return self._pod_name(worker_id)

    def _priority_class(self, slot):
        """First ceil(fraction*num_workers) *slots* ride the high
        priority class (reference pod_manager.py:80-99).  Keyed by slot,
        not launch id, so a relaunched high-priority worker keeps its
        protection instead of eroding the protected core."""
        if not self._high_fraction or not self._num_workers:
            return self._priority_low or None
        n_high = math.ceil(self._high_fraction * self._num_workers)
        if slot < n_high:
            return self._priority_high
        return self._priority_low or None

    def _attach_owner(self, manifest):
        if self._owner_ref:
            manifest["metadata"]["ownerReferences"] = [{
                "apiVersion": "v1",
                "kind": "Pod",
                "name": self._owner_ref["name"],
                "uid": self._owner_ref["uid"],
                "controller": True,
                "blockOwnerDeletion": True,
            }]
        return manifest

    def _apply_spec_hook(self, manifest, hook_name):
        return apply_spec_hook(self._cluster_spec, manifest, hook_name)

    def pod_manifest(self, worker_id, master_addr, slot=None,
                     extra_env=None):
        slot = worker_id if slot is None else slot
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": self._pod_name(worker_id),
                "labels": {
                    LABEL_JOB: self._job_name,
                    LABEL_TYPE: "worker",
                    LABEL_INDEX: str(worker_id),
                },
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": [{
                    "name": "worker",
                    "image": self._image,
                    "command": ["python", "-m",
                                "elasticdl_tpu_torch.worker.main"],
                    "args": [str(a) for a in self._worker_args],
                    "env": [
                        {"name": "MASTER_ADDR", "value": master_addr},
                        {"name": "WORKER_ID", "value": str(worker_id)},
                    ] + [
                        {"name": k, "value": str(v)}
                        for k, v in sorted((extra_env or {}).items())
                    ],
                    "resources": container_resources(self._resources),
                }],
            },
        }
        if self._volumes:
            manifest["spec"]["volumes"] = [
                dict(v) for v in self._volumes
            ]
            manifest["spec"]["containers"][0]["volumeMounts"] = [
                dict(m) for m in self._volume_mounts
            ]
        priority = self._priority_class(slot)
        if priority:
            manifest["spec"]["priorityClassName"] = priority
        self._attach_owner(manifest)
        return self._apply_spec_hook(manifest, "patch_pod")

    def service_manifest(self, worker_id, select_worker_id=None):
        """Service for a worker slot; ``select_worker_id`` lets a
        relaunch re-point the original slot's service at the
        replacement pod."""
        target = (
            worker_id if select_worker_id is None else select_worker_id
        )
        manifest = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": self._service_name(worker_id),
                "labels": {
                    LABEL_JOB: self._job_name,
                    LABEL_TYPE: "worker",
                    LABEL_INDEX: str(worker_id),
                },
            },
            "spec": {
                "selector": {
                    LABEL_JOB: self._job_name,
                    LABEL_TYPE: "worker",
                    LABEL_INDEX: str(target),
                },
                "ports": [{"port": 50002, "targetPort": 50002}],
            },
        }
        self._attach_owner(manifest)
        return self._apply_spec_hook(manifest, "patch_service")

    # -- WorkerManager backend surface --------------------------------------

    def slot_addresses(self, num_workers, port=50002):
        """Stable host:port per worker SLOT — the slot services point at
        whichever pod currently fills the slot, so these addresses stay
        valid across relaunches.  Feed them to
        ``cluster_spec_env.make_tf_config_fn`` for foreign-runtime
        cluster specs (reference pod_manager.py:405-422)."""
        return [
            "%s.%s.svc:%d" % (self._service_name(slot), self._namespace,
                              port)
            for slot in range(num_workers)
        ]

    def launch(self, worker_id, master_addr, slot=None, extra_env=None):
        """``slot`` is the stable replica slot (WorkerHandle.slot): on a
        relaunch it is the ORIGINAL slot id, so the slot's service keeps
        re-pointing at each replacement no matter how many times the
        worker dies."""
        slot = worker_id if slot is None else slot
        pod = self.pod_manifest(worker_id, master_addr, slot=slot,
                                extra_env=extra_env)
        self._core.create_namespaced_pod(self._namespace, pod)
        if slot != worker_id:
            # Keep the slot's service and re-point it at the replacement
            # (reference common/k8s_client.py:261-274).
            self.patch_service(slot, worker_id)
        else:
            self._core.create_namespaced_service(
                self._namespace, self.service_manifest(worker_id)
            )
        event = threading.Event()
        event.code = None
        self._exit_events[self._pod_name(worker_id)] = event
        return self._pod_name(worker_id)

    def patch_service(self, slot, new_worker_id):
        body = self.service_manifest(slot, select_worker_id=new_worker_id)
        try:
            self._core.patch_namespaced_service(
                self._service_name(slot), self._namespace, body
            )
        except Exception as e:  # noqa: BLE001 — service may be gone
            logger.warning(
                "patch service %s -> worker %d failed (%s); recreating",
                self._service_name(slot), new_worker_id, e,
            )
            try:
                # Self-heal: a missing/deleted slot service comes back
                # already selecting the replacement pod.
                self._core.create_namespaced_service(self._namespace, body)
            except Exception as e2:  # noqa: BLE001
                logger.warning(
                    "recreate service %s failed: %s",
                    self._service_name(slot), e2,
                )

    def wait(self, ref):
        """Block until the pod reaches a terminal phase; return an exit
        code (0 ok, 1 failed, 137 OOM, -9 deleted/preempted)."""
        event = self._exit_events[ref]
        while not event.wait(timeout=self._poll_secs):
            try:
                pod = self._core.read_namespaced_pod(ref, self._namespace)
            except Exception:
                event.code = -9  # pod gone: preempted/deleted
                break
            phase = self._phase(pod)
            if phase == "Succeeded":
                event.code = 0
                break
            if phase == "Failed":
                event.code = self._exit_code(pod)
                break
        self._exit_events.pop(ref, None)  # bound long-job growth
        return event.code

    @staticmethod
    def _phase(pod):
        if isinstance(pod, dict):
            return pod.get("status", {}).get("phase")
        return pod.status.phase

    @staticmethod
    def _exit_code(pod):
        code = 1
        if isinstance(pod, dict):
            statuses = pod.get("status", {}).get(
                "containerStatuses", []
            ) or []
            for s in statuses:
                term = (s.get("state") or {}).get("terminated")
                if term is not None:
                    code = term.get("exitCode", 1)
        else:
            for s in pod.status.container_statuses or []:
                term = s.state.terminated
                if term is not None:
                    code = term.exit_code
        return code

    def kill(self, ref, force=False):
        try:
            self._core.delete_namespaced_pod(
                ref, self._namespace,
                grace_period_seconds=0 if force else 30,
            )
        except Exception as e:
            logger.warning("delete pod %s failed: %s", ref, e)

    def is_alive(self, ref):
        try:
            pod = self._core.read_namespaced_pod(ref, self._namespace)
        except Exception:
            return False
        return self._phase(pod) in ("Pending", "Running")
