"""One process builds, the others wait: ``ops/build.py`` (``nvcc``) and
``native/build.py`` (``g++``) hold a lock file beside each library while
they compile it, so two processes that start on a cold build directory
(two workers, or a master's PS shards) run each compiler once between
them, and both come back with the library's path.

The compilers are stand-ins (a script that logs its call, sleeps, and
writes the ``-o`` file): the tests run where there is no CUDA toolkit,
and what is under test is who compiles, not what.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILER = """#!%s
import sys, time
with open(%r, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
time.sleep(1.0)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").close()
"""

_NVCC_BUILD = """
from elasticdl_tpu_torch.ops import build
print(sorted(build.build_all()))
"""

_WORKER_PREBUILD = """
from elasticdl_tpu_torch.worker import main
main._prebuild_kernels().join(timeout=60)
"""

_GXX_BUILD = """
from elasticdl_tpu_torch.native import build
print(build.build())
"""


def _stand_in(path, log):
    path.write_text(_COMPILER % (sys.executable, str(log)))
    path.chmod(0o755)


def _race(code, env, n=2):
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return outs


def test_two_processes_run_each_nvcc_once(tmp_path):
    log = tmp_path / "calls.log"
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    _stand_in(tmp_path / "cuda" / "bin" / "nvcc", log)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               ELASTICDL_TORCH_BUILD_DIR=str(tmp_path / "build"))
    outs = _race(_NVCC_BUILD, env)
    sources = ["flash_attention", "flash_attention_bwd", "group_norm",
               "group_norm_bwd"]
    assert [o.strip() for o in outs] == [str(sources)] * 2
    calls = log.read_text().splitlines()
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls) == [
        s + ".cu" for s in sources]
    built = sorted(p for p in os.listdir(tmp_path / "build")
                   if p.endswith(".so"))
    assert len(built) == 4
    # Warm: nothing compiles again.
    _race(_NVCC_BUILD, env)
    assert len(log.read_text().splitlines()) == 4


def test_two_workers_prebuild_each_kernel_once(tmp_path):
    """A worker on the card starts every kernel build as it starts
    (``worker/main.py``): two of them on a cold build directory compile
    each source once between them."""
    log = tmp_path / "calls.log"
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    _stand_in(tmp_path / "cuda" / "bin" / "nvcc", log)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               ELASTICDL_TORCH_BUILD_DIR=str(tmp_path / "build"))
    _race(_WORKER_PREBUILD, env)
    assert len(log.read_text().splitlines()) == 4
    assert len([p for p in os.listdir(tmp_path / "build")
                if p.endswith(".so")]) == 4


def test_two_processes_run_gxx_once(tmp_path):
    log = tmp_path / "calls.log"
    (tmp_path / "bin").mkdir()
    _stand_in(tmp_path / "bin" / "g++", log)
    env = dict(os.environ, ELASTICDL_TORCH_BUILD_DIR=str(tmp_path / "build"),
               PATH=os.pathsep.join([str(tmp_path / "bin"),
                                     os.environ.get("PATH", "")]))
    outs = _race(_GXX_BUILD, env, n=3)
    paths = {o.strip() for o in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.isfile(path)
    assert os.path.basename(path).startswith("libedlkernels-")
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    assert "-march=native" not in calls[0] and "kernels.cc" in calls[0]
