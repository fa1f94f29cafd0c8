"""Versioned checkpoints with validity checks and GC: the dense,
single-writer part of ``elasticdl_tpu/utils/checkpoint.py``.

The directory scheme and payload are the JAX package's, so a checkpoint
written by either package loads in the other:

    <dir>/version-<v>/variables-<i>-of-<N>.ckpt

Each shard file is a numpy .npz of named dense arrays (``dense/<name>``).
A version is valid iff all N of its shard files are present, so a reader
can tell a torn write from a complete one.  This saver writes one shard
(N = 1), as the JAX trainer's saver does, and reads the dense arrays of
any complete layout.  The parameter-server path's sharded writer
(per-shard save, restore, rollback and GC, and embedding tables) is not
here: it comes with that path.
"""

import os
import re
import shutil

import numpy as np

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SHARD_RE = re.compile(r"variables-(\d+)-of-(\d+)\.ckpt$")


def _version_dir(root, version):
    return os.path.join(root, "version-%d" % version)


def _shard_file(root, version, i, n):
    return os.path.join(
        _version_dir(root, version), "variables-%d-of-%d.ckpt" % (i, n)
    )


class CheckpointSaver:
    def __init__(self, checkpoint_dir, keep_max=3):
        self._dir = checkpoint_dir
        self._keep_max = keep_max
        os.makedirs(checkpoint_dir, exist_ok=True)

    def save(self, version, dense):
        """Write ``{name: ndarray}`` as version ``version`` (one shard,
        written to a temporary name and renamed into place), then drop
        the oldest versions beyond ``keep_max``."""
        os.makedirs(_version_dir(self._dir, version), exist_ok=True)
        payload = {"dense/" + name: np.asarray(arr)
                   for name, arr in dense.items()}
        path = _shard_file(self._dir, version, 0, 1)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        self._gc()
        return path

    def versions(self):
        out = []
        if not os.path.isdir(self._dir):
            return out
        for entry in os.listdir(self._dir):
            m = re.match(r"version-(\d+)$", entry)
            if m and self.is_valid_version(int(m.group(1))):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self):
        versions = self.versions()
        return versions[-1] if versions else None

    def is_valid_version(self, version):
        """A version is valid iff, for some layout N, all N of its
        ``variables-*-of-N.ckpt`` files are present."""
        return self._complete_layout(version) is not None

    def _complete_layout(self, version):
        """The shard count N of the most recently written complete
        layout under this version's directory, or None."""
        vdir = _version_dir(self._dir, version)
        if not os.path.isdir(vdir):
            return None
        by_layout = {}
        for entry in os.listdir(vdir):
            m = _SHARD_RE.search(entry)
            if m:
                by_layout.setdefault(int(m.group(2)), set()).add(
                    int(m.group(1))
                )
        best, best_mtime = None, None
        for n, shards in by_layout.items():
            if shards != set(range(n)):
                continue
            mtime = max(
                os.path.getmtime(_shard_file(self._dir, version, i, n))
                for i in range(n)
            )
            if best is None or mtime > best_mtime:
                best, best_mtime = n, mtime
        return best

    def load(self, version=None):
        """The dense arrays of a version (the newest valid one by
        default): returns ``({name: ndarray}, version)``.  Raises
        FileNotFoundError when there is none, and ValueError for a
        checkpoint that holds embedding tables."""
        if version is None:
            version = self.latest_version()
        if version is None:
            raise FileNotFoundError("no valid checkpoint in %s" % self._dir)
        layout = self._complete_layout(version)
        if layout is None:
            raise FileNotFoundError(
                "version-%d in %s is torn" % (version, self._dir)
            )
        dense = {}
        for i in range(layout):
            path = _shard_file(self._dir, version, i, layout)
            with np.load(path) as z:
                for key in z.files:
                    kind, name = key.split("/", 1)
                    if kind != "dense":
                        raise ValueError(
                            "%s holds %s; this saver reads dense arrays "
                            "only" % (path, key))
                    dense[name] = z[key]
        return dense, version

    def _gc(self):
        versions = self.versions()
        while len(versions) > self._keep_max:
            victim = versions.pop(0)
            shutil.rmtree(_version_dir(self._dir, victim), ignore_errors=True)
            logger.info("checkpoint GC: removed version-%d", victim)
