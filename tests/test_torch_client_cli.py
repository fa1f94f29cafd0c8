"""The port's ``elasticdl-tpu-torch`` CLI (elasticdl_tpu_torch/client/
main.py): the twins of ``tests/test_client_cli.py`` under their names,
on the CPU.

Where the port's CLI differs, so do the twins: the scaffold ``zoo
init`` writes is a torch zoo module (it imports no JAX, and its
``model_spec`` trains a step on the port's trainer), ``serve`` runs the
port's server over a port export, and ``inspect`` reads port exports,
a dense checkpoint and a parameter-server checkpoint.
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np

from elasticdl_tpu_torch.client.main import _split_args, _zoo_init, main
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.serving import export as texport
from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "elasticdl_tpu")

# The scaffold trains one step on the port's trainer, in a process where
# importing any package of BANNED raises.
SCAFFOLD_STEP = """
import importlib.util, sys
import numpy as np
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
spec_mod = importlib.util.spec_from_file_location("my_model", sys.argv[1])
module = importlib.util.module_from_spec(spec_mod)
spec_mod.loader.exec_module(module)
spec = module.model_spec()
rng = np.random.RandomState(0)
records = [(rng.randn(8).astype(np.float32), i % 2) for i in range(16)]
xs, ys = spec.feed(records)
trainer = CollectiveTrainer(spec, batch_size=16, device="cpu")
loss, version = trainer.train_minibatch(xs, ys)
print("%s %r %d" % (spec.name, float(loss), version))
"""


def _banned_path(tmp_path):
    poison = tmp_path / "banned"
    for name in BANNED:
        os.makedirs(poison / name)
        (poison / name / "__init__.py").write_text(
            "raise ImportError(%r)\n" % ("%s imported" % name))
    return str(poison)


def test_zoo_init_scaffolds_project(tmp_path):
    path = str(tmp_path / "zoo")

    class A:
        pass

    args = A()
    args.path = path
    assert _zoo_init(args) == 0
    model_file = os.path.join(path, "my_model.py")
    assert os.path.exists(model_file)
    with open(os.path.join(path, "Dockerfile")) as f:
        dockerfile = f.read()
    assert "torch" in dockerfile and "cu128" in dockerfile
    assert "jax" not in dockerfile
    # scaffolded model module must satisfy the port's zoo contract: it
    # imports no JAX and trains a step with a finite loss
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([_banned_path(tmp_path), REPO])
    out = subprocess.run(
        [sys.executable, "-c", SCAFFOLD_STEP, model_file], env=env,
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    name, loss, version = out.stdout.split()
    assert name == "my_model" and version == "1"
    assert np.isfinite(float(loss)) and float(loss) > 0


def test_zoo_build_and_push_shell_out(tmp_path, monkeypatch):
    """``zoo build/push`` drive the docker CLI.  A fake ``docker`` on
    PATH records the exact invocations and its exit code must
    propagate."""
    import stat

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "docker_calls.log"
    fake = bin_dir / "docker"
    fake.write_text(
        "#!/bin/sh\necho \"$@\" >> %s\nexit ${DOCKER_FAKE_RC:-0}\n"
        % calls
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv(
        "PATH", "%s:%s" % (bin_dir, os.environ["PATH"]))

    zoo = tmp_path / "zoo"
    assert main(["zoo", "init", str(zoo)]) == 0
    assert main(["zoo", "build", str(zoo),
                 "--image", "repo/img:v1"]) == 0
    assert main(["zoo", "push", "--image", "repo/img:v1"]) == 0
    lines = calls.read_text().splitlines()
    assert lines == [
        "build -t repo/img:v1 %s" % zoo,
        "push repo/img:v1",
    ]

    monkeypatch.setenv("DOCKER_FAKE_RC", "3")
    assert main(["zoo", "push", "--image", "repo/img:v1"]) == 3


def test_split_args_passthrough():
    cli, rest = _split_args([
        "--platform", "k8s", "--image", "img:1",
        "--model_zoo", "mnist", "--batch_size", "64",
    ])
    assert cli.platform == "k8s" and cli.image == "img:1"
    assert rest == ["--model_zoo", "mnist", "--batch_size", "64"]


def test_k8s_manifest_renders_master_pod():
    from elasticdl_tpu_torch.client.k8s_submit import render_manifests

    manifest = render_manifests(
        ["--job_name", "myjob", "--model_zoo", "mnist"],
        image="img:2", namespace="ml",
    )
    assert '"name": "myjob-master"' in manifest
    assert '"namespace": "ml"' in manifest
    assert '"image": "img:2"' in manifest
    assert '"--model_zoo"' in manifest
    assert '"elasticdl_tpu_torch.master.main"' in manifest

    # --volume in the job args mounts on the master pod too
    manifest = render_manifests(
        ["--job_name", "myjob", "--volume",
         "claim_name=data,mount_path=/data"],
        image="img:2",
    )
    assert '"claimName": "data"' in manifest
    assert '"mountPath": "/data"' in manifest


def test_k8s_service_port_follows_job_port():
    """An explicit --port parameterizes the Service port/targetPort so
    worker pods dialing the service DNS name reach the master."""
    from elasticdl_tpu_torch.client.k8s_submit import build_manifests

    _pod, svc = build_manifests(
        ["--job_name", "j", "--port", "6100"], image="i")
    assert svc["spec"]["ports"] == [{"port": 6100, "targetPort": 6100}]
    _pod, svc = build_manifests(["--job_name", "j"], image="i")
    assert svc["spec"]["ports"] == [
        {"port": 50001, "targetPort": 50001}]


def test_cli_help_and_unknown():
    assert main([]) == 1


def test_cli_train_local_runs_a_port_job(tmp_path):
    """``train --platform local`` runs the port's master and its worker
    processes, none of which imports JAX: a job of 4 tasks finishes with
    none failed."""
    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([_banned_path(tmp_path), REPO])
    out = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
         "--platform", "local", "--data_origin", "synthetic_mnist:512",
         "--model_zoo", "mnist", "--batch_size", "32",
         "--num_minibatches_per_task", "4", "--num_workers", "1"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "launched worker 0" in out.stderr
    assert re.search(r"job finished: .*'completed': \{0: 4, .*'failed': "
                     r"\{0: 0, ", out.stderr), out.stderr


def _mnist_export(path, version=0, quantize=None, seed=0):
    spec = load_model_spec("mnist")
    module = spec.init_fn("cpu", seed=seed)
    return texport.export_servable(
        str(path), "mnist", "", module, np.zeros((1, 28, 28), np.float32),
        model_name="srv", version=version, quantize=quantize)


def test_cli_serve_end_to_end(tmp_path):
    """`elasticdl-tpu-torch serve` over a fresh port export: the full
    export -> serve -> predict loop through the CLI."""
    from elasticdl_tpu_torch.utils.grpc_utils import find_free_port

    _mnist_export(tmp_path / "e")
    x = np.random.RandomState(1).rand(2, 28, 28).astype(np.float32)
    want = tloader.load_servable(str(tmp_path / "e"),
                                 device="cpu").predict(x)
    port = find_free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "serve",
         "--export_dir", str(tmp_path / "e"), "--port", str(port),
         "--host", "127.0.0.1"],
        env=dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu",
                 OMP_NUM_THREADS="1"),
    )
    base = "http://127.0.0.1:%d/v1/models/srv" % port
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(base, timeout=5) as resp:
                    meta = json.loads(resp.read())
                break
            except OSError:
                if time.time() > deadline:
                    raise
                assert proc.poll() is None, "server died"
                time.sleep(0.3)
        assert meta["metadata"]["model_name"] == "srv"
        req = urllib.request.Request(
            base + ":predict",
            data=json.dumps({"instances": x.tolist()}).encode(),
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        np.testing.assert_allclose(out["predictions"], want, atol=1e-6,
                                   rtol=1e-6)
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_inspect_export_and_checkpoint(tmp_path, capsys):
    """`elasticdl-tpu-torch inspect` summarizes port exports (incl.
    versioned + quantized, with their program), a dense checkpoint and a
    parameter-server checkpoint (tables beside the dense arrays)."""
    base = str(tmp_path / "models")
    for version in (1, 3):
        _mnist_export(os.path.join(base, str(version)), version=version,
                      quantize="int8")
    assert main(["inspect", base]) == 0
    out = capsys.readouterr().out
    assert "versions on disk: [1, 3]" in out
    assert "int8-quantized: Conv_1/kernel, Dense_0/kernel" in out
    assert "model_name: srv" in out and "version: 3" in out
    assert "program: model.pt2" in out
    assert "parameters: 8 arrays" in out

    ckpt = str(tmp_path / "ckpt")
    saver = CheckpointSaver(ckpt)
    saver.save(7, dense={"w": np.ones(4, np.float32),
                         "opt/w": np.zeros(4, np.float32)})
    assert main(["inspect", ckpt]) == 0
    out = capsys.readouterr().out
    assert "version-7: 1 shard file(s)" in out
    assert ("latest loadable: version 7 — 2 dense arrays (1 optimizer), "
            "0 embedding tables") in out

    ps = str(tmp_path / "ps_ckpt")
    rows = np.arange(6, dtype=np.int64)
    for shard in range(2):
        mine = rows[rows % 2 == shard]
        CheckpointSaver(ps).save_shard(
            5, shard, 2,
            dense={"dense_%d" % shard: np.ones(3, np.float32),
                   "optslot/dense_%d@m" % shard: np.zeros(3, np.float32)},
            embeddings={"emb": (mine, np.ones((len(mine), 4),
                                              np.float32))})
    assert main(["inspect", ps]) == 0
    out = capsys.readouterr().out
    assert "version-5: 2 shard file(s)" in out
    assert ("latest loadable: version 5 — 4 dense arrays (2 optimizer), "
            "1 embedding tables") in out
    assert "table emb: 6 rows" in out

    assert main(["inspect", str(tmp_path / "nope")]) == 1
