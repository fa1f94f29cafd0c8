"""Where the port's serving path sets process-wide numerics: loading a
servable leaves TF32 as it found it (as the JAX loader sets nothing),
and the serving entry point turns it off before it loads the model, so
that served float32 predictions compute in float32 on the card.  Both
run on the CPU: the flags are process-wide settings whatever the
device."""

import pytest
import torch

from elasticdl_tpu_torch.serving import loader as tloader
from elasticdl_tpu_torch.serving import server as tserver
from tests.test_torch_serving import _port_export


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        saved)


def test_loading_a_servable_leaves_tf32_alone(tmp_path, tf32_on):
    _port_export(tmp_path)
    tloader.load_servable(str(tmp_path), device="cpu")
    assert tf32_flags() == (True, True)


def test_serving_entry_point_turns_tf32_off(tmp_path, tf32_on, monkeypatch):
    _port_export(tmp_path)
    monkeypatch.setenv("ELASTICDL_TORCH_DEVICE", "cpu")

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            assert tf32_flags() == (False, False)

        def server_close(self):
            pass

    monkeypatch.setattr(tserver, "build_server", lambda *a, **k: Server())
    assert tserver.main(["--export_dir", str(tmp_path)]) == 0
    assert tf32_flags() == (False, False)
