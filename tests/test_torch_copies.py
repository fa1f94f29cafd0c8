"""The port's byte-identical copies stay identical (ROADMAP Queue C, C-a).

Each module listed here is the JAX package's module, copied: with the
package name normalised (``elasticdl_tpu_torch`` read as
``elasticdl_tpu``) the two files are equal byte for byte.  None of them
imports JAX, so the JAX package's own tests of these modules
(``tests/test_task_manager.py``, ``test_tensor_codec.py``,
``test_pserver.py``, ``test_native_kernels.py``, ``test_sync_atomic.py``,
``test_ps_frame_wire.py``, ``test_ps_recovery.py`` and others) cover the
port's copies too.  A copy that must change leaves this list in the same
change and gets a twin of its reference tests.
"""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IDENTICAL = (
    "data/parallel_reader.py", "data/reader.py", "data/recio.py",
    "data/recio_gen.py", "data/token_reader.py",
    "master/evaluation_service.py", "master/journal.py", "master/master.py",
    "master/ps_manager.py", "master/servicer.py", "master/task_manager.py",
    "master/worker_state.py",
    "native/bindings.py", "native/kernels.cc",
    "proto/elastic_pb2.py", "proto/rpc.py",
    "ps/optimizer.py", "ps/parameters.py", "ps/server.py", "ps/servicer.py",
    "utils/grpc_utils.py", "utils/hashing.py", "utils/hist.py",
    "utils/jsonline.py", "utils/metric_registry.py", "utils/metrics.py",
    "utils/prom.py", "utils/retry.py", "utils/slo.py",
    "utils/tensor_codec.py",
    "worker/data_shard_service.py", "worker/master_client.py",
    "worker/ps_client.py", "worker/task_data_service.py",
)


def _read(package, path):
    with open(os.path.join(REPO, package, path), "rb") as f:
        return f.read()


@pytest.mark.parametrize("path", IDENTICAL)
def test_port_copy_is_the_reference_module(path):
    port = _read("elasticdl_tpu_torch", path)
    # The copy imports its own package, never the reference's.
    assert not re.search(rb"(?m)^\s*(from|import)\s+elasticdl_tpu\b(?!_)",
                         port)
    normalised = port.replace(b"elasticdl_tpu_torch", b"elasticdl_tpu")
    assert normalised == _read("elasticdl_tpu", path), (
        "elasticdl_tpu_torch/%s differs from elasticdl_tpu/%s; a copy that "
        "must differ leaves IDENTICAL and gets a twin of its tests" % (
            path, path))
