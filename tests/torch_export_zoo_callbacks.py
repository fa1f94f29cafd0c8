"""A test-only zoo entry: the port's mnist with a ``ModelExporter``
train-end callback, so the master schedules a train-end task and a
worker writes a versioned servable into ``export_dir``."""

from elasticdl_tpu_torch.models import mnist
from elasticdl_tpu_torch.models.callbacks import ModelExporter


def model_spec(export_dir="", **kwargs):
    spec = mnist.model_spec(**kwargs)
    spec.callbacks = [ModelExporter(str(export_dir), model_name="mnist",
                                    versioned=True)]
    return spec
