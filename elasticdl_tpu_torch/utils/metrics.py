"""Streaming evaluation metrics (numpy), copied from
``elasticdl_tpu/utils/metrics.py:12-50``: small stateful reducers over
model outputs, so the master that aggregates them needs no ML
framework."""

import numpy as np


class Metric:
    def update(self, outputs, labels):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class Mean(Metric):
    """Mean of a per-example scalar produced by fn(outputs, labels)."""

    def __init__(self, fn):
        self._fn = fn
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def update(self, outputs, labels):
        values = np.asarray(self._fn(outputs, labels), dtype=np.float64)
        self._total += values.sum()
        self._count += values.size

    def result(self):
        return self._total / max(1, self._count)


class Accuracy(Mean):
    def __init__(self):
        super().__init__(
            lambda outputs, labels: (
                np.argmax(outputs, axis=-1) == np.asarray(labels).reshape(-1)
            ).astype(np.float64)
        )
