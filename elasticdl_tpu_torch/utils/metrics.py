"""Streaming evaluation metrics (numpy).

The reference aggregates worker-reported model outputs into Keras metric
objects (elasticdl/python/common/evaluation_utils.py:20-110).  Here metrics
are small stateful numpy reducers so the master needs no ML framework at
all — workers do device math, the master only accumulates.
"""

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


class BinaryAccuracy(Mean):
    def __init__(self, threshold=0.5):
        super().__init__(
            lambda outputs, labels: (
                (np.asarray(outputs).reshape(-1) > threshold)
                == (np.asarray(labels).reshape(-1) > 0.5)
            ).astype(np.float64)
        )


class MeanSquaredError(Mean):
    def __init__(self):
        super().__init__(
            lambda outputs, labels: (
                (np.asarray(outputs).reshape(-1)
                 - np.asarray(labels).reshape(-1)) ** 2
            )
        )


class MeanAbsoluteError(Mean):
    def __init__(self):
        super().__init__(
            lambda outputs, labels: np.abs(
                np.asarray(outputs).reshape(-1)
                - np.asarray(labels).reshape(-1)
            )
        )


class TopKAccuracy(Mean):
    """Label in the top-k logits (Keras SparseTopKCategoricalAccuracy)."""

    def __init__(self, k=5):
        def fn(outputs, labels):
            outputs = np.asarray(outputs)
            labels = np.asarray(labels).reshape(-1)
            topk = np.argsort(outputs, axis=-1)[:, -k:]
            return (topk == labels[:, None]).any(axis=-1).astype(
                np.float64
            )

        super().__init__(fn)


class _ConfusionCounts(Metric):
    """Shared TP/FP/FN accumulator for precision/recall."""

    def __init__(self, threshold=0.5):
        self._threshold = threshold
        self.reset()

    def reset(self):
        self.tp = self.fp = self.fn = 0

    def update(self, outputs, labels):
        pred = np.asarray(outputs).reshape(-1) > self._threshold
        truth = np.asarray(labels).reshape(-1) > 0.5
        self.tp += int(np.sum(pred & truth))
        self.fp += int(np.sum(pred & ~truth))
        self.fn += int(np.sum(~pred & truth))


class Precision(_ConfusionCounts):
    def result(self):
        return self.tp / max(1, self.tp + self.fp)


class Recall(_ConfusionCounts):
    def result(self):
        return self.tp / max(1, self.tp + self.fn)


class AUC(Metric):
    """Streaming ROC-AUC via fixed-bin histograms of scores."""

    def __init__(self, num_thresholds=200):
        self._bins = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self._bins, dtype=np.float64)
        self._neg = np.zeros(self._bins, dtype=np.float64)

    def update(self, outputs, labels):
        scores = np.clip(np.asarray(outputs, dtype=np.float64).reshape(-1), 0, 1)
        labels = np.asarray(labels).reshape(-1) > 0.5
        idx = np.minimum((scores * self._bins).astype(np.int64), self._bins - 1)
        np.add.at(self._pos, idx[labels], 1.0)
        np.add.at(self._neg, idx[~labels], 1.0)

    def result(self):
        # TPR/FPR walking thresholds from high to low score.
        pos_total = self._pos.sum()
        neg_total = self._neg.sum()
        if pos_total == 0 or neg_total == 0:
            return 0.0
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tpr = np.concatenate([[0.0], tp / pos_total])
        fpr = np.concatenate([[0.0], fp / neg_total])
        return float(np.trapezoid(tpr, fpr))
