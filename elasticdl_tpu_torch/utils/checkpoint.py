"""Versioned, sharded checkpoints with validity checks and GC
(counterpart of ``elasticdl_tpu/utils/checkpoint.py``).

The directory scheme and payload are the JAX package's, so a checkpoint
written by either package loads in the other:

    <dir>/version-<v>/variables-<i>-of-<N>.ckpt

Each shard file is a numpy .npz of named dense arrays (``dense/<name>``)
and embedding tables (``emb_ids/<table>``, ``emb_vals/<table>``).  A
version is valid iff all N of its shard files are present, so a reader
can tell a torn write from a complete one.  Two writers use it:

 - the dense trainers write one shard (N = 1) with ``save`` and read the
   dense arrays of any complete layout with ``load``, as the JAX
   trainer's saver does;
 - the parameter-server shards write ``save_shard`` each, and a
   relaunched shard restores its hash-routed slice of the newest
   COMMITTED label (one all N shards reached) with ``load_shard``,
   truncating its own newer files (``truncate_shard_after``).  Dense
   arrays route by ``utils.hashing.string_to_id`` of their name,
   embedding rows by id mod N, optimizer slots (``optslot/<param>@<slot>``)
   with their parameter, so any shard count re-reads any other.  GC is
   per shard and never removes a committed label's files.  The master
   resumes at ``latest_resumable_version``.
"""

import os
import re
import shutil
import time

import numpy as np

from elasticdl_tpu_torch.utils import hashing
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

    def save_shard(
        self, version, shard_index, num_shards,
        dense=None, embeddings=None, gc=True,
    ):
        """Write one shard of one version.

        dense: {name: ndarray} owned by this shard.
        embeddings: {table_name: (ids ndarray, values ndarray)}.
        """
        os.makedirs(_version_dir(self._dir, version), exist_ok=True)
        payload = {}
        for name, arr in (dense or {}).items():
            payload["dense/" + name] = np.asarray(arr)
        for name, (ids, values) in (embeddings or {}).items():
            payload["emb_ids/" + name] = np.asarray(ids, dtype=np.int64)
            payload["emb_vals/" + name] = np.asarray(values)
        path = _shard_file(self._dir, version, shard_index, num_shards)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        if gc:
            self._gc_shard(shard_index, num_shards)
        return path

    def save(self, version, dense):
        """Write ``{name: ndarray}`` as version ``version`` (one shard,
        written to a temporary name and renamed into place), then drop
        the oldest versions beyond ``keep_max``."""
        os.makedirs(_version_dir(self._dir, version), exist_ok=True)
        payload = {"dense/" + name: np.asarray(arr)
                   for name, arr in dense.items()}
        path = _shard_file(self._dir, version, 0, 1)
        tmp = path + ".tmp"
        start = time.perf_counter()
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        logger.info("checkpoint version %d written: %d bytes in %.3f s",
                    version, os.path.getsize(path),
                    time.perf_counter() - start)
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

    def latest_resumable_version(self, num_shards):
        """Newest version the PS fleet can restore — the committed
        (fully-valid) checkpoint mark.  The master uses this for its
        skip-records resume math so it agrees with what the PS shards
        will actually restore via ``load_shard(None, ...)``: restore is
        coordinated (one consistent label for every shard), so a lone
        shard's newer uncommitted file no longer counts."""
        del num_shards  # a committed label restores under any layout
        return self.latest_version()

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
            try:
                mtime = max(
                    os.path.getmtime(_shard_file(self._dir, version, i, n))
                    for i in range(n)
                )
            except OSError:
                # A sibling shard's GC removed files between listdir and
                # stat — the layout is no longer complete, skip it.
                continue
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

    @staticmethod
    def _read_shard_file(path):
        """Parse one shard .npz into (dense, embeddings) — the single
        payload-format parser shared by every read path."""
        dense, embeddings = {}, {}
        with np.load(path) as z:
            for key in z.files:
                kind, name = key.split("/", 1)
                if kind == "dense":
                    dense[name] = z[key]
                elif kind == "emb_ids":
                    embeddings[name] = (z[key], z["emb_vals/" + name])
        return dense, embeddings

    def _load_all(self, version=None):
        """Load all shards of a version (dense arrays and tables).

        Returns (dense {name: ndarray}, embeddings {name: (ids, values)}).
        """
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
        embeddings = {}
        for i in range(layout):
            shard_dense, shard_emb = self._read_shard_file(
                _shard_file(self._dir, version, i, layout)
            )
            for name, arr in shard_dense.items():
                if name == "optslot/__step__" and name in dense:
                    # Shard step counters drift in async mode; keep the
                    # max so Adam bias correction never moves backward.
                    dense[name] = np.maximum(dense[name], arr)
                else:
                    dense[name] = arr
            for name, (ids, values) in shard_emb.items():
                if name in embeddings:
                    prev_ids, prev_vals = embeddings[name]
                    ids = np.concatenate([prev_ids, ids])
                    values = np.concatenate([prev_vals, values])
                embeddings[name] = (ids, values)
        return dense, embeddings, version

    def shard_versions(self, shard_index, num_shards):
        """Versions that contain this exact shard file (per-shard validity)."""
        out = []
        if not os.path.isdir(self._dir):
            return out
        for entry in os.listdir(self._dir):
            m = re.match(r"version-(\d+)$", entry)
            if m and os.path.isfile(
                _shard_file(self._dir, int(m.group(1)),
                            shard_index, num_shards)
            ):
                out.append(int(m.group(1)))
        return sorted(out)

    def load_shard(self, version, shard_index, num_shards):
        """Load shard_index's slice of a stored version.

        With ``version=None``, restore the newest COMMITTED label — the
        newest version with a complete shard set, so every shard of the
        fleet restores the same consistent version (one-shard relaunch
        or full-fleet restart alike).  A directory holding only
        uncommitted per-shard files (drifted labels, no label complete)
        is REFUSED loudly: silently restoring this shard's own newest
        file would hand the job a mixed-version dense model the workers
        cannot detect (docs/ps_recovery.md, checkpoint barrier).
        """
        if version is None:
            full = self.latest_version()
            if full is None:
                own = self.shard_versions(shard_index, num_shards)
                if own:
                    raise FileNotFoundError(
                        "no committed checkpoint in %s: shard %d/%d has "
                        "only uncommitted per-shard files (labels %r) "
                        "with no label complete across the shard set — "
                        "refusing a mixed-version restore"
                        % (self._dir, shard_index, num_shards, own)
                    )
                raise FileNotFoundError(
                    "no valid checkpoint in %s" % self._dir
                )
        dense, embeddings, version = self._load_all(version)
        my_dense = {
            k: v for k, v in dense.items()
            if self._dense_shard(k, num_shards) in (shard_index, None)
        }
        my_emb = {}
        for name, (ids, values) in embeddings.items():
            sel = ids % num_shards == shard_index
            my_emb[name] = (ids[sel], values[sel])
        return my_dense, my_emb, version

    def truncate_shard_after(self, version, shard_index, num_shards):
        """Remove this shard's files with labels NEWER than ``version``
        — the rollback half of a restore.  A shard restored at the
        committed mark abandons the timeline its dead incarnation was
        on; its newer files belong to that abandoned timeline, and left
        in place one of them could later pair up with a sibling's
        post-restore file under the same label into a fake "committed"
        set that mixes timelines.  Only THIS shard's files go (siblings
        that never died keep their continuous history); dirs left empty
        are removed.  Returns the labels truncated."""
        victims = [
            v for v in self.shard_versions(shard_index, num_shards)
            if v > version
        ]
        for v in victims:
            try:
                os.remove(_shard_file(self._dir, v, shard_index,
                                      num_shards))
            except OSError:
                continue
            try:
                os.rmdir(_version_dir(self._dir, v))
            except OSError:
                pass  # other shards' files still present
        if victims:
            logger.warning(
                "restore rollback: shard %d truncated abandoned-timeline "
                "checkpoints %r (restored at version %d)",
                shard_index, victims, version,
            )
        return victims

    @staticmethod
    def _dense_shard(key, num_shards):
        """Dense routing; optimizer slots follow their parent parameter
        and the step counter replicates to every shard."""
        if key == "optslot/__step__":
            return None  # caller treats None as "all shards"
        if key.startswith("optslot/"):
            key = key[len("optslot/"):].rsplit("@", 1)[0]
        return hashing.string_to_id(key, num_shards)

    def _gc(self):
        versions = self.versions()
        while len(versions) > self._keep_max:
            victim = versions.pop(0)
            shutil.rmtree(_version_dir(self._dir, victim), ignore_errors=True)
            logger.info("checkpoint GC: removed version-%d", victim)

    def _gc_shard(self, shard_index, num_shards):
        """Three-stage GC run after each shard write:

        1. fully-valid versions beyond keep_max are removed whole (the
           classic reference GC, save_utils.py:229-294 semantics);
        2. this shard's own older files beyond keep_max are pruned —
           except from any surviving fully-valid version, so a
           shard-count-change restore is never torn by GC;
        3. stale-layout files (``-of-M`` with M != num_shards) in dirs
           older than the newest fully-valid version are swept, so a
           resize can't strand undeletable dirs forever.

        Dirs left empty are removed; the last shard out deletes the dir.
        """
        self._gc()
        protected = set(self.versions())
        versions = [
            v for v in self.shard_versions(shard_index, num_shards)
            if v not in protected
        ]
        for victim in versions[: -self._keep_max] if self._keep_max else []:
            path = _shard_file(self._dir, victim, shard_index, num_shards)
            try:
                os.remove(path)
            except OSError:
                continue
            try:
                os.rmdir(_version_dir(self._dir, victim))
                logger.info("checkpoint GC: removed version-%d", victim)
            except OSError:
                pass  # other shards' files still present
        newest_valid = max(protected) if protected else None
        if newest_valid is not None:
            self._gc_stale_layouts(num_shards, newest_valid, protected)

    def _gc_stale_layouts(self, num_shards, newest_valid, protected):
        """Remove pre-resize layout files from non-protected dirs older
        than the newest fully-valid version (superseded by it)."""
        for entry in os.listdir(self._dir):
            m = re.match(r"version-(\d+)$", entry)
            if (
                not m
                or int(m.group(1)) >= newest_valid
                or int(m.group(1)) in protected
            ):
                continue
            vdir = os.path.join(self._dir, entry)
            for fname in os.listdir(vdir):
                fm = _SHARD_RE.search(fname)
                if fm and int(fm.group(2)) != num_shards:
                    try:
                        os.remove(os.path.join(vdir, fname))
                    except OSError:
                        pass
            try:
                os.rmdir(vdir)
                logger.info("checkpoint GC: removed stale %s", entry)
            except OSError:
                pass
