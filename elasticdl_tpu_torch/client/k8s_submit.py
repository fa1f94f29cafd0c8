"""Create the master pod on a Kubernetes cluster (real submission path).

Parity: the reference CLI does not just render YAML — it re-serializes
the parsed args into a container command line and CREATES the master pod
through the k8s API (elasticdl_client/api.py:199-256,
common/k8s_client.py:220-357).  This module is that path for
elasticdl-tpu: dict manifests (the k8s API accepts them directly),
created via an injectable CoreV1Api so the whole flow unit-tests against
a fake API with no ``kubernetes`` package in the image.

The master pod gets the reference's label scheme and downward-API env
(POD_NAME / POD_UID), so the in-cluster master can stamp itself as the
ownerReference on every worker pod it creates — deleting the master
cascades the whole job, the reference's ownership model
(common/k8s_client.py:354-357).

Manifest rendering (``--output``) stays available for kubectl-driven
submission; both paths build the same dicts.
"""

import json

from elasticdl_tpu_torch.master.k8s_backend import (
    LABEL_INDEX,
    LABEL_JOB,
    LABEL_TYPE,
    apply_spec_hook,
    default_core_api,
    load_cluster_spec,
)
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MASTER_PORT = 50001


def _argv_value(master_argv, flag, default=None):
    for i, arg in enumerate(master_argv):
        if arg == flag and i + 1 < len(master_argv):
            return master_argv[i + 1]
        if arg.startswith(flag + "="):
            return arg.split("=", 1)[1]
    return default


def _job_name_from_argv(master_argv):
    return _argv_value(master_argv, "--job_name", "elasticdl-tpu-job")


def _port_from_argv(master_argv):
    """The port the in-cluster master will bind (Service must match).

    An explicit ``--port`` in the job args parameterizes the Service
    port/targetPort; otherwise the master falls back to MASTER_PORT
    (master/main.py) and so does the Service.
    """
    port = _argv_value(master_argv, "--port")
    try:
        port = int(port) if port else 0
    except ValueError:
        raise ValueError(
            "--port must be an integer, got %r" % port) from None
    return port or MASTER_PORT


def master_pod_name(job_name):
    return "%s-master" % job_name


def master_pod_manifest(master_argv, image, namespace="default",
                        job_name=None, resources=None, envs=None):
    """The master pod as a dict manifest.

    ``resources``: k8s resource-request dict (see
    k8s_renderer.parse_resource_string).  ``envs``: extra {name: value}
    pairs for the master container.
    """
    job_name = job_name or _job_name_from_argv(master_argv)
    env = [
        {"name": "JOB_NAME", "value": job_name},
        # Downward API: the master learns its own pod identity so it can
        # set itself as ownerReference on the workers it creates.
        {"name": "POD_NAME", "fieldRef": {"fieldPath": "metadata.name"}},
        {"name": "POD_UID", "fieldRef": {"fieldPath": "metadata.uid"}},
        {"name": "POD_NAMESPACE",
         "fieldRef": {"fieldPath": "metadata.namespace"}},
        # Pod IP: the per-epoch coordination services bind fresh ports
        # that the master's Service does not map — workers dial the
        # master POD directly for those (master/main.py coord_host).
        {"name": "POD_IP", "fieldRef": {"fieldPath": "status.podIP"}},
    ]
    env = [
        e if "fieldRef" not in e else
        {"name": e["name"], "valueFrom": {"fieldRef": e["fieldRef"]}}
        for e in env
    ]
    for name, value in (envs or {}).items():
        env.append({"name": name, "value": str(value)})
    # --volume in the job args mounts on the master pod too (the worker
    # pods get the same mounts from K8sWorkerBackend) — reference
    # k8s_volume.py semantics.
    from elasticdl_tpu_torch.client.k8s_renderer import parse_volume_string

    volumes, mounts = parse_volume_string(
        _argv_value(master_argv, "--volume", ""))
    manifest = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": master_pod_name(job_name),
            "namespace": namespace,
            "labels": {
                LABEL_JOB: job_name,
                LABEL_TYPE: "master",
                LABEL_INDEX: "0",
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": "master",
                "image": image,
                "command": ["python", "-m", "elasticdl_tpu_torch.master.main"],
                "args": [str(a) for a in master_argv],
                "env": env,
                "resources": {
                    "requests": dict(
                        resources or {"cpu": "1", "memory": "2Gi"}
                    )
                },
            }],
        },
    }
    if volumes:
        manifest["spec"]["volumes"] = volumes
        manifest["spec"]["containers"][0]["volumeMounts"] = mounts
    return manifest


def master_service_manifest(job_name, namespace="default",
                            port=MASTER_PORT):
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": master_pod_name(job_name),
            "namespace": namespace,
            "labels": {
                LABEL_JOB: job_name,
                LABEL_TYPE: "master",
                LABEL_INDEX: "0",
            },
        },
        "spec": {
            "selector": {
                LABEL_JOB: job_name,
                LABEL_TYPE: "master",
            },
            "ports": [{"port": port, "targetPort": port}],
        },
    }


def render_manifests(master_argv, image, namespace="default",
                     job_name=None, resources=None, envs=None,
                     cluster_spec=""):
    """Multi-doc YAML for kubectl (JSON docs — JSON is valid YAML)."""
    pod, svc = build_manifests(
        master_argv, image, namespace=namespace, job_name=job_name,
        resources=resources, envs=envs, cluster_spec=cluster_spec,
    )
    return "---\n".join(
        json.dumps(doc, indent=2) + "\n" for doc in (pod, svc)
    )


def build_manifests(master_argv, image, namespace="default",
                    job_name=None, resources=None, envs=None,
                    cluster_spec=""):
    spec_mod = (
        load_cluster_spec(cluster_spec)
        if isinstance(cluster_spec, str) else cluster_spec
    )
    job_name = job_name or _job_name_from_argv(master_argv)
    pod = master_pod_manifest(
        master_argv, image, namespace=namespace, job_name=job_name,
        resources=resources, envs=envs,
    )
    svc = master_service_manifest(
        job_name, namespace=namespace, port=_port_from_argv(master_argv)
    )
    return (
        apply_spec_hook(spec_mod, pod, "patch_pod"),
        apply_spec_hook(spec_mod, svc, "patch_service"),
    )


def submit_job(master_argv, image, namespace="default", job_name=None,
               resources=None, envs=None, cluster_spec="",
               core_api=None):
    """Create the master pod + service; returns the master pod name.

    ``core_api`` is injectable (tests use a fake); the default imports
    the real kubernetes client and loads kubeconfig credentials.
    """
    if core_api is None:
        core_api = default_core_api()
    pod, svc = build_manifests(
        master_argv, image, namespace=namespace, job_name=job_name,
        resources=resources, envs=envs, cluster_spec=cluster_spec,
    )
    core_api.create_namespaced_pod(namespace, pod)
    core_api.create_namespaced_service(namespace, svc)
    name = pod["metadata"]["name"]
    logger.info("submitted master pod %s (namespace %s)", name, namespace)
    return name
