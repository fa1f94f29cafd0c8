"""Trainer interface (counterpart of
``elasticdl_tpu/worker/trainer.py:6-38``)."""

import abc


class Trainer(abc.ABC):
    @abc.abstractmethod
    def train_minibatch(self, features, labels):
        """Run one training step; returns (loss, version: int).

        ``loss`` is a LAZY device scalar: no host sync happens here.
        Callers that need a float (cadence logging, benches) convert
        explicitly with ``float(loss)``; that fetch is the device
        fence."""

    @abc.abstractmethod
    def evaluate_minibatch(self, features, labels):
        """Forward pass; returns (outputs ndarray, labels ndarray)."""

    @abc.abstractmethod
    def predict_minibatch(self, features):
        """Forward pass; returns outputs ndarray."""

    def init_from_checkpoint(self):
        return False

    def export_parameters(self):
        """Return {name: ndarray} of the current model parameters."""
        raise NotImplementedError

    def serving_bundle(self):
        """Optional (inference_fn, params, example_input) triple for a
        standalone servable export; None when the trainer can't provide
        one."""
        return None
