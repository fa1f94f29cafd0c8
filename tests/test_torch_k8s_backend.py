"""The port's k8s backend and submission path (elasticdl_tpu_torch/
master/k8s_backend.py, client/{k8s_renderer, k8s_submit}.py), verified
without a cluster, against the JAX package's.

The twins of the 22 cases of ``tests/test_k8s_backend.py`` under their
names, on the port's backend, renderer, submission and master; the
golden pod differs where a GPU pod must: the worker module, extended
resources under ``limits`` too, and no TPU ``nodeSelector``
(``--tpu_topology`` raises).  Then the two packages' backends and CLIs
driven through the same scripted sequence against the same fake API:
the same calls and manifests but for those differences and the module
names.
"""

import copy
import json
import sys
import threading
import types

import pytest

from elasticdl_tpu_torch.client.k8s_renderer import parse_resource_string
from elasticdl_tpu_torch.client.k8s_submit import render_manifests
from elasticdl_tpu_torch.master.k8s_backend import K8sWorkerBackend
from elasticdl_tpu_torch.master.worker_manager import WorkerManager


class FakePod:
    def __init__(self, manifest):
        self.manifest = manifest
        self.phase = "Running"
        self.exit_code = None

    def as_dict(self):
        status = {"phase": self.phase}
        if self.exit_code is not None:
            status["containerStatuses"] = [
                {"state": {"terminated": {"exitCode": self.exit_code}}}
            ]
        return dict(self.manifest, status=status)


class FakeCoreV1Api:
    """Record-and-replay stand-in for kubernetes.client.CoreV1Api."""

    def __init__(self):
        self.pods = {}       # name -> FakePod
        self.services = {}   # name -> manifest
        self.patches = []    # (service_name, body)

    def create_namespaced_pod(self, namespace, body):
        self.pods[body["metadata"]["name"]] = FakePod(body)

    def read_namespaced_pod(self, name, namespace):
        if name not in self.pods:
            raise KeyError(name)
        return self.pods[name].as_dict()

    def delete_namespaced_pod(self, name, namespace,
                              grace_period_seconds=None):
        self.pods.pop(name, None)

    def create_namespaced_service(self, namespace, body):
        self.services[body["metadata"]["name"]] = body

    def patch_namespaced_service(self, name, namespace, body):
        if name not in self.services:
            raise KeyError(name)
        self.services[name] = body
        self.patches.append((name, body))


def make_backend(**kwargs):
    api = FakeCoreV1Api()
    backend = K8sWorkerBackend(
        "job", "image:tag", core_api=api, poll_secs=0.05,
        worker_args=["--model_zoo", "mnist"], **kwargs,
    )
    return api, backend


# -- manifests ----------------------------------------------------------------

def test_pod_manifest_golden():
    _, backend = make_backend(resources={"cpu": "4", "nvidia.com/gpu": "1"})
    pod = backend.pod_manifest(3, "master:50001")
    assert pod == {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": "job-worker-3",
            "labels": {
                "elasticdl-tpu-job-name": "job",
                "replica-type": "worker",
                "replica-index": "3",
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": "worker",
                "image": "image:tag",
                "command": ["python", "-m",
                            "elasticdl_tpu_torch.worker.main"],
                "args": ["--model_zoo", "mnist"],
                "env": [
                    {"name": "MASTER_ADDR", "value": "master:50001"},
                    {"name": "WORKER_ID", "value": "3"},
                ],
                "resources": {
                    "requests": {"cpu": "4", "nvidia.com/gpu": "1"},
                    "limits": {"nvidia.com/gpu": "1"},
                },
            }],
        },
    }


def test_master_manifest_golden_and_resources():
    text = render_manifests(
        ["--job_name", "myjob", "--num_workers", "2"], "img:1",
        namespace="ml",
    )
    assert '"name": "myjob-master"' in text
    assert '"namespace": "ml"' in text
    assert '"master"' in text
    assert '"--num_workers"' in text and '"2"' in text
    assert '"kind": "Service"' in text  # master service alongside
    assert parse_resource_string("cpu=1,memory=4Gi,google.com/tpu=8") == {
        "cpu": "1", "memory": "4Gi", "google.com/tpu": "8",
    }


def test_priority_split():
    """First ceil(fraction*num_workers) workers get the high class."""
    _, backend = make_backend(num_workers=4, high_priority_fraction=0.5,
                              priority_class_high="hi",
                              priority_class_low="lo")
    classes = [
        backend.pod_manifest(i, "m:1")["spec"].get("priorityClassName")
        for i in range(4)
    ]
    assert classes == ["hi", "hi", "lo", "lo"]


def test_cluster_spec_hooks_patch_manifests():
    mod = types.ModuleType("fake_cluster_spec")

    def patch_pod(manifest):
        manifest["spec"]["tolerations"] = [{"key": "tpu"}]
        return manifest

    def patch_service(manifest):
        manifest["metadata"]["labels"]["site"] = "dc-7"
        return manifest

    mod.patch_pod = patch_pod
    mod.patch_service = patch_service
    sys.modules["fake_cluster_spec"] = mod
    try:
        _, backend = make_backend(cluster_spec="fake_cluster_spec")
        pod = backend.pod_manifest(0, "m:1")
        svc = backend.service_manifest(0)
        assert pod["spec"]["tolerations"] == [{"key": "tpu"}]
        assert svc["metadata"]["labels"]["site"] == "dc-7"
    finally:
        del sys.modules["fake_cluster_spec"]


# -- backend lifecycle against the fake API -----------------------------------

def test_launch_creates_pod_and_service():
    api, backend = make_backend()
    ref = backend.launch(0, "m:1")
    assert ref == "job-worker-0"
    assert "job-worker-0" in api.pods
    assert "job-worker-0" in api.services
    sel = api.services["job-worker-0"]["spec"]["selector"]
    assert sel["replica-index"] == "0"


def test_wait_maps_phases_to_exit_codes():
    api, backend = make_backend()
    for phase, exit_code, want in (
        ("Succeeded", None, 0),
        ("Failed", 1, 1),
        ("Failed", 137, 137),   # OOMKilled -> no relaunch upstream
    ):
        ref = backend.launch(9, "m:1")
        api.pods[ref].phase = phase
        api.pods[ref].exit_code = exit_code
        done = {}

        def run():
            done["code"] = backend.wait(ref)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=10)
        assert done["code"] == want, (phase, exit_code, done)


def test_wait_reports_deleted_pod_as_preemption():
    api, backend = make_backend()
    ref = backend.launch(1, "m:1")
    backend.kill(ref, force=True)  # pod gone from the API
    assert backend.wait(ref) == -9
    assert not backend.is_alive(ref)


def test_relaunch_patches_service_to_replacement():
    """The reference's service continuity: worker 0 dies, worker 1
    replaces it, and slot 0's service now selects worker 1's pod."""
    api, backend = make_backend()
    backend.launch(0, "m:1")
    backend.launch(1, "m:1", slot=0)
    assert len(api.patches) == 1
    name, body = api.patches[0]
    assert name == "job-worker-0"
    assert body["spec"]["selector"]["replica-index"] == "1"
    # no second service created for the replacement
    assert "job-worker-1" not in api.services


def test_second_relaunch_keeps_slot_service_chain():
    """Worker 1 (already a replacement for slot 0) dies and worker 2
    replaces it: slot 0's service must select worker 2 (review r2: the
    predecessor-id chain broke here, patching a nonexistent service)."""
    api, backend = make_backend()
    backend.launch(0, "m:1")
    backend.launch(1, "m:1", slot=0)
    backend.launch(2, "m:1", slot=0)
    sel = api.services["job-worker-0"]["spec"]["selector"]
    assert sel["replica-index"] == "2"
    assert "job-worker-1" not in api.services
    assert "job-worker-2" not in api.services


def test_patch_missing_service_self_heals():
    api, backend = make_backend()
    backend.launch(0, "m:1")
    del api.services["job-worker-0"]  # deleted externally
    backend.launch(1, "m:1", slot=0)
    # self-healed: recreated, selecting the replacement
    sel = api.services["job-worker-0"]["spec"]["selector"]
    assert sel["replica-index"] == "1"


def test_relaunched_high_priority_slot_keeps_protection():
    """Priority follows the slot: the replacement for a high-priority
    worker stays high (review r2: the protected core eroded)."""
    _, backend = make_backend(num_workers=4, high_priority_fraction=0.5,
                              priority_class_high="hi",
                              priority_class_low="lo")
    pod = backend.pod_manifest(7, "m:1", slot=0)  # replacement for slot 0
    assert pod["spec"]["priorityClassName"] == "hi"
    pod = backend.pod_manifest(8, "m:1", slot=3)
    assert pod["spec"]["priorityClassName"] == "lo"


def test_pod_manifest_carries_extra_env_and_slot_addresses():
    """The foreign-runtime cluster-spec hook on the k8s backend: the
    TF_CONFIG (or any) extra env rides the pod manifest, and
    slot_addresses() yields the stable per-slot service DNS names to
    build it from (reference pod_manager.py:405-422)."""
    _, backend = make_backend()
    addrs = backend.slot_addresses(2)
    assert addrs == ["job-worker-0.default.svc:50002",
                     "job-worker-1.default.svc:50002"]
    pod = backend.pod_manifest(
        1, "m:1", extra_env={"TF_CONFIG": '{"task": 1}'})
    env = {e["name"]: e["value"]
           for e in pod["spec"]["containers"][0]["env"]}
    assert env["TF_CONFIG"] == '{"task": 1}'
    assert env["WORKER_ID"] == "1"


def test_volume_string_mounts_on_worker_pods():
    """--volume (reference elasticdl_client/common/k8s_volume.py): PVC
    and hostPath entries become pod volumes + container mounts; a
    repeated claim reuses ONE volume with two mounts."""
    from elasticdl_tpu_torch.client.k8s_renderer import parse_volume_string

    volumes, mounts = parse_volume_string(
        "claim_name=data,mount_path=/data;"
        "claim_name=data,mount_path=/data2,sub_path=sub,read_only=true;"
        "host_path=/mnt/ssd,mount_path=/ssd"
    )
    assert [v["name"] for v in volumes] == [
        "pvc-data-f363", "hostpath-mnt-ssd-4c86"]
    assert volumes[0]["persistentVolumeClaim"]["claimName"] == "data"
    assert volumes[1]["hostPath"]["path"] == "/mnt/ssd"
    assert mounts[1] == {"name": "pvc-data-f363", "mountPath": "/data2",
                         "subPath": "sub", "readOnly": True}
    # Near-identical sources must NOT collapse to one volume name.
    vols2, _ = parse_volume_string(
        "claim_name=data.x,mount_path=/a;claim_name=data-x,mount_path=/b")
    assert len({v["name"] for v in vols2}) == 2

    import pytest as _pytest

    with _pytest.raises(ValueError):
        parse_volume_string("claim_name=c")  # no mount_path
    with _pytest.raises(ValueError):
        parse_volume_string("mount_path=/p")  # no source

    _, backend = make_backend(volume="claim_name=data,mount_path=/data")
    pod = backend.pod_manifest(0, "m:1")
    assert pod["spec"]["volumes"][0]["name"] == "pvc-data-f363"
    assert (pod["spec"]["containers"][0]["volumeMounts"][0]["mountPath"]
            == "/data")


def test_worker_manager_drives_k8s_relaunch_end_to_end():
    """WorkerManager + K8sWorkerBackend against the fake API: preempt a
    pod (delete it), watch the DELETED -> relaunch flow create a fresh
    pod and patch the dead slot's service onto it."""
    api = FakeCoreV1Api()
    backend = K8sWorkerBackend("job", "img", core_api=api,
                               poll_secs=0.05)
    mgr = WorkerManager(backend, num_workers=1)
    mgr.set_master_addr("m:1")
    mgr.start()
    assert "job-worker-0" in api.pods
    # preempt: delete the pod out from under the watcher
    api.delete_namespaced_pod("job-worker-0", "default")
    deadline = threading.Event()
    for _ in range(100):
        if "job-worker-1" in api.pods:
            break
        deadline.wait(0.1)
    assert "job-worker-1" in api.pods, "no relaunch pod appeared"
    assert api.patches and api.patches[0][0] == "job-worker-0"
    assert (
        api.patches[0][1]["spec"]["selector"]["replica-index"] == "1"
    )
    # the relaunched pod carries slot 0's replica semantics end to end
    assert "job-worker-1" not in api.services
    mgr.stop()


# -- client submission path (VERDICT r2 #5) ----------------------------------

def test_submit_job_creates_master_pod_and_service():
    from elasticdl_tpu_torch.client import k8s_submit

    api = FakeCoreV1Api()
    argv = ["--job_type", "train", "--job_name", "myjob",
            "--model_zoo", "mnist"]
    name = k8s_submit.submit_job(
        argv, image="img:1", namespace="ns", core_api=api,
        resources={"cpu": "2"},
    )
    assert name == "myjob-master"
    pod = api.pods["myjob-master"].manifest
    assert pod["metadata"]["labels"] == {
        "elasticdl-tpu-job-name": "myjob",
        "replica-type": "master",
        "replica-index": "0",
    }
    assert pod["metadata"]["namespace"] == "ns"
    c = pod["spec"]["containers"][0]
    assert c["command"] == ["python", "-m",
                            "elasticdl_tpu_torch.master.main"]
    assert c["args"] == argv
    assert c["resources"]["requests"] == {"cpu": "2"}
    # downward-API identity for worker ownerReferences
    fields = {
        e["name"]: e["valueFrom"]["fieldRef"]["fieldPath"]
        for e in c["env"] if "valueFrom" in e
    }
    assert fields["POD_NAME"] == "metadata.name"
    assert fields["POD_UID"] == "metadata.uid"
    svc = api.services["myjob-master"]
    assert svc["spec"]["selector"]["replica-type"] == "master"
    assert svc["spec"]["ports"][0]["port"] == 50001


def test_submit_job_applies_cluster_spec_hooks():
    from elasticdl_tpu_torch.client import k8s_submit

    mod = types.ModuleType("fake_submit_spec")
    mod.patch_pod = lambda m: (
        m["spec"].__setitem__("nodeSelector", {"pool": "tpu"}) or m
    )
    sys.modules["fake_submit_spec"] = mod
    try:
        api = FakeCoreV1Api()
        k8s_submit.submit_job(
            ["--job_name", "j2"], image="img", core_api=api,
            cluster_spec="fake_submit_spec",
        )
        pod = api.pods["j2-master"].manifest
        assert pod["spec"]["nodeSelector"] == {"pool": "tpu"}
    finally:
        del sys.modules["fake_submit_spec"]


def test_cli_k8s_platform_submits_via_api():
    from elasticdl_tpu_torch.client.main import _run_job

    api = FakeCoreV1Api()
    rc = _run_job(
        "train",
        ["--platform", "k8s", "--image", "img:2",
         "--namespace", "prod", "--job_name", "cli-job",
         "--model_zoo", "mnist",
         "--master_resource_request", "cpu=3,memory=1Gi"],
        core_api=api,
    )
    assert rc == 0
    pod = api.pods["cli-job-master"].manifest
    assert pod["spec"]["containers"][0]["image"] == "img:2"
    assert pod["metadata"]["namespace"] == "prod"
    assert pod["spec"]["containers"][0]["resources"]["requests"] == {
        "cpu": "3", "memory": "1Gi",
    }
    # --job_type was prepended for the master
    args = pod["spec"]["containers"][0]["args"]
    assert args[:2] == ["--job_type", "train"]
    # a cluster submission defaults the master to k8s worker PODS —
    # without this the workers run as subprocesses inside the master
    # pod (ADVICE r3 medium)
    assert args[args.index("--worker_backend") + 1] == "k8s"


def test_cli_k8s_explicit_worker_backend_wins():
    from elasticdl_tpu_torch.client.main import _run_job

    api = FakeCoreV1Api()
    rc = _run_job(
        "train",
        ["--platform", "k8s", "--job_name", "pj",
         "--model_zoo", "mnist", "--worker_backend", "process"],
        core_api=api,
    )
    assert rc == 0
    args = api.pods["pj-master"].manifest["spec"]["containers"][0]["args"]
    assert args.count("--worker_backend") == 1
    assert args[args.index("--worker_backend") + 1] == "process"


def test_cli_k8s_output_renders_manifest(tmp_path):
    import json as _json

    from elasticdl_tpu_torch.client.main import _run_job

    out = tmp_path / "job.yaml"
    rc = _run_job(
        "train",
        ["--platform", "k8s", "--job_name", "rjob",
         "--output", str(out), "--model_zoo", "mnist"],
    )
    assert rc == 0
    docs = out.read_text().split("---\n")
    pod = _json.loads(docs[0])
    svc = _json.loads(docs[1])
    assert pod["metadata"]["name"] == "rjob-master"
    assert svc["kind"] == "Service"


def test_worker_pods_carry_owner_reference():
    api = FakeCoreV1Api()
    backend = K8sWorkerBackend(
        "job", "image:tag", core_api=api, poll_secs=0.05,
        worker_args=[], owner_ref={"name": "job-master", "uid": "u-123"},
    )
    backend.launch(0, "master:50001")
    pod = api.pods["job-worker-0"].manifest
    ref = pod["metadata"]["ownerReferences"][0]
    assert ref["name"] == "job-master"
    assert ref["uid"] == "u-123"
    assert ref["controller"] is True
    svc = api.services["job-worker-0"]
    assert svc["metadata"]["ownerReferences"][0]["uid"] == "u-123"


def test_owner_ref_from_env():
    from elasticdl_tpu_torch.master.k8s_backend import owner_ref_from_env

    assert owner_ref_from_env({}) is None
    assert owner_ref_from_env(
        {"POD_NAME": "m", "POD_UID": "u"}
    ) == {"name": "m", "uid": "u"}


def test_master_builds_k8s_backend_from_flags(monkeypatch):
    from elasticdl_tpu_torch.master.main import _build_worker_backend
    from elasticdl_tpu_torch.utils.args import parse_master_args

    monkeypatch.setenv("POD_NAME", "job-master")
    monkeypatch.setenv("POD_UID", "u-9")
    args = parse_master_args([
        "--worker_backend", "k8s", "--image", "w:1",
        "--namespace", "ns", "--num_workers", "4",
        "--worker_resource_request", "cpu=1",
        "--worker_pod_priority", "0.5",
    ])
    backend = _build_worker_backend(args, ["--model_zoo", "mnist"])
    assert isinstance(backend, K8sWorkerBackend)
    backend._core = FakeCoreV1Api()
    backend.launch(0, "m:1")
    pod = backend._core.pods["elasticdl-tpu-job-worker-0"].manifest
    assert pod["spec"]["containers"][0]["image"] == "w:1"
    assert pod["metadata"]["ownerReferences"][0]["uid"] == "u-9"
    # first ceil(0.5*4)=2 slots ride the high priority class
    assert pod["spec"]["priorityClassName"] == "high-priority"


# -- where a GPU pod differs --------------------------------------------------

def test_extended_resources_go_under_limits_too():
    """Kubernetes never overcommits an extended resource: the API server
    refuses a container that requests ``nvidia.com/gpu`` without the same
    limit.  The flag string a user passes renders a pod a GPU node
    takes; cpu, memory and ephemeral storage stay requests only."""
    resources = parse_resource_string(
        "cpu=4,memory=16Gi,ephemeral-storage=10Gi,nvidia.com/gpu=1")
    _, backend = make_backend(resources=resources)
    got = backend.pod_manifest(0, "m:1")["spec"]["containers"][0][
        "resources"]
    assert got == {
        "requests": {"cpu": "4", "memory": "16Gi",
                     "ephemeral-storage": "10Gi", "nvidia.com/gpu": "1"},
        "limits": {"nvidia.com/gpu": "1"},
    }
    _, backend = make_backend(resources={"cpu": "1"})
    got = backend.pod_manifest(0, "m:1")["spec"]["containers"][0][
        "resources"]
    assert got == {"requests": {"cpu": "1"}}


def test_tpu_topology_is_refused_by_name():
    """A GKE TPU nodeSelector would schedule a GPU pod nowhere: the
    backend raises naming the flag, from the constructor and from the
    master's flags; the parser keeps the flag (shared argv)."""
    from elasticdl_tpu_torch.master.main import _build_worker_backend
    from elasticdl_tpu_torch.utils.args import parse_master_args

    with pytest.raises(ValueError, match="--tpu_topology"):
        make_backend(tpu_topology="2x2")
    args = parse_master_args(["--worker_backend", "k8s",
                              "--tpu_topology", "2x2"])
    assert args.tpu_topology == "2x2"
    with pytest.raises(ValueError, match="--tpu_topology"):
        _build_worker_backend(args, [])


# -- the port against the JAX package -----------------------------------------

class RecordingCoreV1Api(FakeCoreV1Api):
    """The fake API, recording every call with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def create_namespaced_pod(self, namespace, body):
        self.calls.append(("create_pod", namespace, copy.deepcopy(body)))
        super().create_namespaced_pod(namespace, body)

    def read_namespaced_pod(self, name, namespace):
        self.calls.append(("read_pod", name, namespace))
        return super().read_namespaced_pod(name, namespace)

    def delete_namespaced_pod(self, name, namespace,
                              grace_period_seconds=None):
        self.calls.append(("delete_pod", name, namespace,
                           grace_period_seconds))
        super().delete_namespaced_pod(name, namespace)

    def create_namespaced_service(self, namespace, body):
        self.calls.append(("create_service", namespace,
                           copy.deepcopy(body)))
        super().create_namespaced_service(namespace, body)

    def patch_namespaced_service(self, name, namespace, body):
        self.calls.append(("patch_service", name, namespace,
                           copy.deepcopy(body)))
        super().patch_namespaced_service(name, namespace, body)


def _drive_backend(backend_cls):
    """One scripted life of a job's workers: launches under the priority
    split with owner references, phases read to exit codes, a pod
    deleted under its watcher, relaunches that re-point the slot's
    Service (twice), a missing Service healed.  Returns (API calls,
    results)."""
    api = RecordingCoreV1Api()
    backend = backend_cls(
        "job", "img:7", namespace="ns", worker_args=["--model_zoo", "mnist"],
        resources={"cpu": "4", "memory": "16Gi", "nvidia.com/gpu": "1"},
        num_workers=4, high_priority_fraction=0.5,
        priority_class_high="hi", priority_class_low="lo",
        core_api=api, poll_secs=0.01,
        owner_ref={"name": "job-master", "uid": "u-1"},
        volume="claim_name=data,mount_path=/data",
    )
    results = []
    refs = [backend.launch(w, "job-master.ns.svc:50001") for w in range(4)]
    results.append(refs)
    api.pods[refs[0]].phase = "Succeeded"
    api.pods[refs[1]].phase = "Failed"
    api.pods[refs[1]].exit_code = 137
    results.append([backend.wait(refs[0]), backend.wait(refs[1])])
    results.append([backend.is_alive(r) for r in refs])
    backend.kill(refs[2], force=True)
    results.append(backend.wait(refs[2]))
    results.append(backend.launch(4, "job-master.ns.svc:50001", slot=2))
    results.append(backend.launch(5, "job-master.ns.svc:50001", slot=2))
    del api.services["job-worker-3"]
    results.append(backend.launch(6, "job-master.ns.svc:50001", slot=3,
                                  extra_env={"TF_CONFIG": "{}"}))
    backend.kill(refs[3])
    results.append(backend.slot_addresses(4))
    return api.calls, results


def _without_documented_differences(obj):
    """The port's side of the comparison with its documented differences
    taken out: the module names read as the reference's, and the
    ``limits`` of a container dropped."""
    obj = json.loads(json.dumps(obj).replace("elasticdl_tpu_torch",
                                             "elasticdl_tpu"))

    def strip(node):
        if isinstance(node, dict):
            if "requests" in node:
                node.pop("limits", None)
            for v in node.values():
                strip(v)
        elif isinstance(node, list):
            for v in node:
                strip(v)

    strip(obj)
    return obj


def test_backends_make_the_same_api_calls():
    from elasticdl_tpu.master.k8s_backend import (
        K8sWorkerBackend as JK8sWorkerBackend,
    )

    j_calls, j_results = _drive_backend(JK8sWorkerBackend)
    calls, results = _drive_backend(K8sWorkerBackend)
    assert results == j_results
    assert len(calls) == len(j_calls)
    # The port's pods carry the GPU under limits; nothing else differs.
    pods = [c[2] for c in calls if c[0] == "create_pod"]
    assert pods and all(
        p["spec"]["containers"][0]["resources"]["limits"]
        == {"nvidia.com/gpu": "1"} for p in pods)
    assert all(p["spec"]["containers"][0]["command"][-1]
               == "elasticdl_tpu_torch.worker.main" for p in pods)
    assert _without_documented_differences(calls) == json.loads(
        json.dumps(j_calls))


@pytest.mark.parametrize("extra", [
    [],
    ["--port", "6100", "--volume", "claim_name=data,mount_path=/data",
     "--worker_resource_request", "cpu=4,memory=16Gi,nvidia.com/gpu=1",
     "--distribution_strategy", "collective"],
    ["--worker_backend", "process", "--master_resource_request",
     "cpu=2,memory=4Gi"],
])
def test_rendered_submission_matches_the_reference(extra, capsys):
    """``train --platform k8s --output -`` from each CLI on the same
    argv renders the same master pod and Service, but for the module
    names."""
    from elasticdl_tpu.client.main import main as jmain
    from elasticdl_tpu_torch.client.main import main

    argv = ["train", "--platform", "k8s", "--output", "-", "--job_name",
            "rj", "--namespace", "ml", "--image", "img:3", "--model_zoo",
            "resnet", "--num_workers", "2"] + extra
    assert jmain(list(argv)) == 0
    want = capsys.readouterr().out
    assert main(list(argv)) == 0
    got = capsys.readouterr().out
    assert "elasticdl_tpu_torch.master.main" in got
    assert got.replace("elasticdl_tpu_torch", "elasticdl_tpu") == want
    pod = json.loads(got.split("---\n")[0])
    args = pod["spec"]["containers"][0]["args"]
    assert args[args.index("--worker_backend") + 1] == (
        "process" if "process" in extra else "k8s")


# -- C-c: a relaunched pool worker dials the Service ---------------------------


def _master_addr(pod):
    env = pod.manifest["spec"]["containers"][0]["env"]
    return next(e["value"] for e in env if e["name"] == "MASTER_ADDR")


def test_relaunched_pool_worker_dials_the_master_service(monkeypatch,
                                                         tmp_path):
    """A ``--jobs_spec`` pool under ``--worker_backend k8s``: a worker pod
    deleted and relaunched by the manager carries the master Service's DNS
    name, as the pool's first pods do.  The multi-tenant master's
    ``prepare()`` (master/scheduler.py, a copy of the reference's) sets
    ``localhost:<port>``, which a pod cannot reach; the port's
    master/main.py rewrites it as it is set."""
    import socket

    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.scheduler import MultiTenantMaster
    from elasticdl_tpu_torch.utils.args import parse_master_args

    api = FakeCoreV1Api()

    def build_backend(args, worker_args):
        return K8sWorkerBackend(args.job_name, "img",
                                namespace=args.namespace, core_api=api,
                                poll_secs=0.05, worker_args=worker_args)

    seen = {}

    def run(self):
        try:
            seen["first"] = _master_addr(api.pods["pool-worker-0"])
            api.delete_namespaced_pod("pool-worker-0", "ns")
            for _ in range(100):
                if "pool-worker-1" in api.pods:
                    break
                threading.Event().wait(0.1)
            seen["relaunched"] = _master_addr(api.pods["pool-worker-1"])
        finally:
            self.stop()
        return 0

    monkeypatch.setattr(master_main, "_build_worker_backend", build_backend)
    monkeypatch.setattr(MultiTenantMaster, "run", run)
    spec_path = str(tmp_path / "jobs.json")
    with open(spec_path, "w") as f:
        json.dump([{"name": "a", "data_origin": "synthetic_mnist:128"}], f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = parse_master_args([
        "--jobs_spec", spec_path, "--num_workers", "1",
        "--worker_backend", "k8s", "--job_name", "pool",
        "--namespace", "ns", "--port", str(port), "--status_port", "-1"])
    assert master_main._run_multitenant(args) == 0
    want = "pool-master.ns.svc:%d" % port
    assert seen == {"first": want, "relaunched": want}
