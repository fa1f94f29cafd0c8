"""The port package imports torch and never JAX, flax, optax or the JAX
package, resolves its device without falling back to the CPU, and is
clean under the repo's concurrency lint (tools/elastic_lint)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from elasticdl_tpu_torch.utils import device as device_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, importlib, sys
import elasticdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    elasticdl_tpu_torch.__path__, "elasticdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "elasticdl_tpu"))
print(json.dumps({"modules": names, "banned": banned}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("serving.server", "ops.group_norm", "ops.build",
                 "ops.flash_attention", "parallel.ring_attention",
                 "parallel.mesh", "parallel.transport", "parallel.ulysses",
                 "parallel.spmd_trainer", "parallel.launch",
                 "models.transformer", "models.lora",
                 "models.mnist", "models.resnet", "models.spec",
                 "utils.checkpoint", "utils.metrics",
                 "utils.timing", "worker.trainer",
                 "worker.collective_trainer",
                 # the master/worker process path
                 "proto.elastic_pb2", "proto.rpc", "utils.args",
                 "utils.logging", "utils.hist", "utils.retry",
                 "utils.slo", "utils.grpc_utils", "utils.tensor_codec",
                 "utils.tracing", "utils.hashing", "data.reader",
                 "data.recio", "data.recio_gen", "data.token_reader",
                 "data.parallel_reader", "data.factory",
                 "master.worker_state", "master.journal",
                 "master.task_manager", "master.rendezvous",
                 "master.evaluation_service", "master.servicer",
                 "master.master", "master.worker_manager", "master.main",
                 "worker.master_client", "worker.data_shard_service",
                 "worker.task_data_service", "worker.worker",
                 "worker.main", "worker.fused_driver",
                 # the managed elastic-collective path
                 "api.controller", "parallel.distributed",
                 # ZeRO-1 weight-update sharding
                 "worker.zero",
                 # the wrap-your-own-loop API
                 "api.dataset", "models.mnist_torch",
                 # MobileNetV2 and the MLP; predict and evaluate jobs;
                 # the status server, /metrics and the profiler adapter
                 "models.mobilenet", "models.mlp",
                 "worker.prediction_outputs_processor",
                 "master.status_server", "utils.prom",
                 "utils.metric_registry", "utils.jsonline"):
        assert "elasticdl_tpu_torch." + name in result["modules"]
    assert result["banned"] == []


def test_every_kernel_source_is_built():
    """Each CUDA source in ``ops/csrc`` is one library that ``build_all``
    compiles (``chip_smoke.py`` builds them all on the card)."""
    from elasticdl_tpu_torch.ops import build

    assert build.sources() == ["flash_attention", "flash_attention_bwd",
                               "group_norm", "group_norm_bwd"]
    for name in build.sources():
        assert os.path.basename(build.library_path(name)).startswith(
            "lib%s-" % name)


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        device_mod.resolve_device(None)      # the default is the card
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_port_package_is_lint_clean():
    """``python -m tools.elastic_lint elasticdl_tpu_torch`` finds nothing:
    the server's deliberate unlocked snapshot read and its serialized
    predict carry the lint's own justified inline pragmas."""
    if REPO not in sys.path:  # tools/ is not an installed package
        sys.path.insert(0, REPO)
    from tools.elastic_lint import DEFAULT_BASELINE, run_paths

    findings = run_paths([os.path.join(REPO, "elasticdl_tpu_torch")],
                         baseline_path=DEFAULT_BASELINE, jobs=1)
    assert not findings, "\n".join(
        "%s:%d: %s %s" % (f.path, f.line, f.rule, f.message)
        for f in findings)
