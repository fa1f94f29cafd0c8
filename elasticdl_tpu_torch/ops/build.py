"""Builds the port's CUDA kernels at first use and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which is loaded
with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  Libraries land in ``ops/_build/`` under a name that carries a
hash of the flags and of every source and header in ``csrc/``: editing
a source rebuilds it, an unchanged one is reused.  A library is written
to a temporary name and renamed into place, so a concurrent build never
loads a torn file.

``build_all()`` starts one ``nvcc`` per source, all together, and waits
for them; ``library(name)`` builds one on demand.  Both raise on any
compiler failure with the compiler's output.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# -Xptxas -v prints registers, shared memory and spills per kernel; the
# output is returned by build_all() for the caller to show.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
_lock = threading.Lock()


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s/bin and on PATH); the port's "
            "kernels are built with the CUDA toolkit" % home)
    return found


def sources():
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(name.encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, name + ".cu")] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode())
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        "lib%s-%s.so" % (name, digest.hexdigest()[:16]))


class _Build:
    """One nvcc run; ``proc`` is None when the library is up to date."""

    def __init__(self, name):
        self.name = name
        self.path = library_path(name)
        self.proc = None
        self.output = ""
        if os.path.isfile(self.path):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.tmp = "%s.tmp-%d-%d" % (self.path, os.getpid(),
                                     threading.get_ident())
        cmd = [nvcc_path()] + NVCC_FLAGS + [
            "-o", self.tmp, os.path.join(CSRC, self.name + ".cu")]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)

    def finish(self):
        if self.proc is None:
            return self.path
        self.output = self.proc.communicate()[0].decode(errors="replace")
        if self.proc.returncode != 0:
            if os.path.exists(self.tmp):
                os.remove(self.tmp)
            raise RuntimeError("nvcc failed for %s.cu (exit %d):\n%s" % (
                self.name, self.proc.returncode, self.output))
        os.replace(self.tmp, self.path)
        return self.path

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def build_all():
    """Compile every source in ``csrc/`` concurrently.  Returns
    ``{name: compiler output}`` ("" for a library already built)."""
    builds = [_Build(name) for name in sources()]
    try:
        for build in builds:
            build.finish()
    finally:
        for build in builds:
            build.kill()
    return {build.name: build.output for build in builds}


def library(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built first if
    needed; loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_Build(name).finish())
            _libs[name] = lib
        return lib
