"""Builds the native parameter-server core (``kernels.cc``) with ``g++``
at first use (counterpart of ``elasticdl_tpu/native/build.py``).

The library lands in ``native/_build/`` (or ``$ELASTICDL_TORCH_BUILD_DIR``)
under a name that carries a hash of the compiler flags and of the
source, so an edited source rebuilds and an unchanged one is reused; a
file's mtime plays no part.  The flags name no host CPU (no
``-march=native``): a build directory copied to another machine loads
there.  One process builds while the others wait on a lock file beside
the library, then load what it wrote; the build writes a temporary name
of its process and renames it into place, so no process loads a torn
file.  Run ``python -m elasticdl_tpu_torch.native.build`` to build by
hand.
"""

import fcntl
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "kernels.cc")
BUILD_DIR = os.environ.get("ELASTICDL_TORCH_BUILD_DIR") or os.path.join(
    HERE, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def library_path():
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        "libedlkernels-%s.so" % digest.hexdigest()[:16])


def build(force=False):
    """The library's path, compiled first if it is missing (or if
    ``force``).  Raises with the compiler's output on failure."""
    path = library_path()
    if not force and os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        # Blocks while another process builds; the file exists after.
        fcntl.flock(fd, fcntl.LOCK_EX)
        if force or not os.path.isfile(path):
            tmp = "%s.tmp-%d" % (path, os.getpid())
            out = subprocess.run(
                ["g++"] + CXX_FLAGS + ["-o", tmp, SRC],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if out.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError("g++ failed for kernels.cc (exit %d):\n%s"
                                   % (out.returncode,
                                      out.stdout.decode(errors="replace")))
            os.replace(tmp, path)
    finally:
        os.close(fd)  # closing the descriptor releases the lock
    return path


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
