"""Prediction output handling (parity:
elasticdl/python/worker/prediction_outputs_processor.py:17-35;
counterpart of ``elasticdl_tpu/worker/prediction_outputs_processor.py``).

``NpzPredictionWriter`` keeps the reference's file name
(``predictions-worker-<id>.npz``) and its ``process``/``flush``
interface, with one repair: the JAX writer drops its rows at each
``flush`` and writes the file anew, so a worker that predicts more than
one task keeps only its last task's rows.  Here the rows of every
finished task accumulate, and each ``flush`` rewrites the file whole,
atomically (a temporary name, then ``os.replace``), so a reader never
sees a torn file and a worker killed mid-write leaves the previous one.
A relaunched worker takes a fresh id (``master/worker_manager.py``), so
it never overwrites what a dead one wrote.  The cost: a worker holds all
its rows in memory, and a job of T tasks writes O(T^2) rows in all
(ROADMAP Queue C gives the size where that stops being acceptable).
"""

import abc
import os
import threading

import numpy as np


class BasePredictionOutputsProcessor(abc.ABC):
    @abc.abstractmethod
    def process(self, predictions, worker_id):
        """Called per prediction minibatch with the model outputs."""


class NpzPredictionWriter(BasePredictionOutputsProcessor):
    """Accumulates prediction batches and writes one .npz per worker."""

    def __init__(self, output_dir):
        self.output_dir = output_dir
        self._chunks = []        # every batch processed, in order
        self._flushed = 0        # how many of them the file holds
        self._worker_id = None
        self._lock = threading.Lock()
        os.makedirs(output_dir, exist_ok=True)

    def process(self, predictions, worker_id):
        with self._lock:
            self._chunks.append(np.asarray(predictions))
            self._worker_id = worker_id

    def flush(self):
        """Write every row processed so far; returns the file's path, or
        None when there is nothing new to write."""
        with self._lock:
            if len(self._chunks) == self._flushed:
                return None
            path = os.path.join(
                self.output_dir, "predictions-worker-%d.npz" % self._worker_id)
            tmp = "%s.tmp-%d" % (path, os.getpid())
            with open(tmp, "wb") as f:
                np.savez(f, predictions=np.concatenate(self._chunks))
            os.replace(tmp, path)
            self._flushed = len(self._chunks)
        return path
