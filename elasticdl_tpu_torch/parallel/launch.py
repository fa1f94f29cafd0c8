"""Start the ranks of a ``torch.distributed`` world as local processes.

``spawn(fn, world_size, args)`` runs ``fn(*args)`` in ``world_size``
processes made with ``torch.multiprocessing``'s spawn context, each with
its process group initialised (a file store in a temporary directory,
so concurrent worlds on one host never share an address) and torn down
after, and returns each rank's result in rank order.  A rank that raises
fails the whole run with its traceback, and a rank that does not finish
within ``timeout`` seconds fails it too: every process is stopped before
``spawn`` returns or raises, so a hung rank never hangs the caller.  The
default group is gloo's; a mesh's groups take the backend their caller
names (``parallel/mesh.py``), gloo for ranks that share a card.

``fn`` must be importable by name in a fresh interpreter (a module-level
function), and its arguments and result picklable.
"""

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world_size, store, threads, fn, args, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                world_size=world_size, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # Pickled here: a tensor put on the queue as it is would be shared
        # through a descriptor that closes when this process exits.
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size, args=(), timeout=600.0, threads=None):
    """Run ``fn(*args)`` in each of ``world_size`` ranks; returns their
    results, rank 0 first.  ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="edl-ranks-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world_size, store, threads, fn, args, results))
        for rank in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        "ranks %s of %d exited without a result (exit codes "
                        "%s)" % (dead, world_size,
                                 [procs[r].exitcode for r in dead])) from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "ranks %s of %d did not finish within %.0f s" % (
                            sorted(set(range(world_size)) - set(out)),
                            world_size, timeout)) from None
                continue
            if not ok:
                raise RuntimeError("rank %d of %d failed:\n%s"
                                   % (rank, world_size, value))
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
