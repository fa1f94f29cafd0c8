"""Start the ranks of a ``torch.distributed`` world as local processes.

``spawn(fn, world_size, args)`` runs ``fn(*args)`` in ``world_size``
processes made with ``torch.multiprocessing``'s spawn context, each with
its process group initialised (a file store in a temporary directory,
so concurrent worlds on one host never share an address) and torn down
after, and returns each rank's result in rank order.  ``run(calls)``
is the same without a world: each ``(fn, args)`` in a process of its
own (the elastic path's ranks, which form their worlds themselves).  A
process that raises fails the whole run with its traceback, and one that
does not finish within ``timeout`` seconds fails it too: every process is
stopped before ``run`` or ``spawn`` returns or raises, so a hung process
never hangs the caller.  The default group is gloo's; a mesh's groups
take the backend their caller names (``parallel/mesh.py``), gloo for
ranks that share a card.

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


def _process_main(index, threads, fn, args, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        out = fn(*args)
        # Pickled here: a tensor put on the queue as it is would be shared
        # through a descriptor that closes when this process exits.
        results.put((index, True, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((index, False, traceback.format_exc()))


def _in_world(rank, world_size, store, fn, args):
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world_size, rank=rank)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def run(calls, timeout=600.0, threads=None):
    """Run each ``(fn, args)`` of ``calls`` in a spawned process of its
    own; returns their results in order.  ``threads`` sets each process's
    ``torch.set_num_threads``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    n = len(calls)
    procs = [ctx.Process(target=_process_main, daemon=True, args=(
        i, threads, fn, tuple(args), results))
        for i, (fn, args) in enumerate(calls)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        while len(out) < n:
            try:
                i, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        "processes %s of %d exited without a result (exit "
                        "codes %s)" % (dead, n,
                                       [procs[i].exitcode for i in dead])
                    ) from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "processes %s of %d did not finish within %.0f s" % (
                            sorted(set(range(n)) - set(out)), n, timeout)
                    ) from None
                continue
            if not ok:
                raise RuntimeError("process %d of %d failed:\n%s"
                                   % (i, n, value))
            out[i] = pickle.loads(value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[i] for i in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        results.close()


def spawn(fn, world_size, args=(), timeout=600.0, threads=None):
    """Run ``fn(*args)`` in each of ``world_size`` ranks of one world;
    returns their results, rank 0 first."""
    tmp = tempfile.mkdtemp(prefix="edl-ranks-")
    store = os.path.join(tmp, "store")
    try:
        return run([(_in_world, (rank, world_size, store, fn, args))
                    for rank in range(world_size)], timeout, threads)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
