"""Elastic PyTorch training loop (counterpart of
``elasticdl_tpu/models/mnist_torch.py``) — parity with the reference's
model_zoo/mnist/mnist_pytorch.py:32-120 pattern: a stock torch loop made
elastic by (a) an ElasticDataset that pulls master-assigned record
indices and (b) the controller's elastic_run wrapper reporting batch
completion.  This is the "wrap your own loop" API surface.

As in the JAX package's example, the workers synchronise no gradients
(no ``mesh_builder``): each trains its own copy on the records the
master hands it.  Where it differs: the loop runs on ``device`` (the
card unless the caller asks for the CPU; each batch is copied there),
and the initial weights come from ``torch.Generator(seed)`` on the CPU,
so they are the same on every device, or from a given ``state_dict``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.api.controller import ElasticCollectiveController
from elasticdl_tpu_torch.api.dataset import ElasticDataset
from elasticdl_tpu_torch.models import mnist as mnist_zoo
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def build_torch_model(seed=0):
    """The reference's MLP, its weights drawn as ``nn.Linear`` draws
    them (kaiming-uniform weights, uniform biases) from a CPU generator
    seeded with ``seed``."""
    model = torch.nn.Sequential(
        torch.nn.Flatten(),
        torch.nn.Linear(28 * 28, 128),
        torch.nn.ReLU(),
        torch.nn.Linear(128, 10),
    )
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in (model[1], model[3]):
            torch.nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5),
                                           generator=gen)
            bound = 1.0 / math.sqrt(layer.in_features)
            torch.nn.init.uniform_(layer.bias, -bound, bound, generator=gen)
    return model


def train(master_client, n_records=512, batch_size=32, lr=1e-2,
          device=None, seed=0, state_dict=None):
    """Returns (final_loss, batches_run).  ``state_dict``: the model's
    initial weights (``seed``'s draw otherwise)."""
    device = resolve_device(device)
    xs, ys = mnist_zoo.synthetic_data(n=n_records)
    source = [(xs[i], ys[i]) for i in range(len(ys))]
    dataset = ElasticDataset(source, master_client,
                             batch_size=batch_size)
    model = build_torch_model(seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    controller = ElasticCollectiveController(
        master_client, trainer=model,
        data_shard_service=dataset.shard_service,
        global_batch_num=1, check_secs=1e9,
    )

    def train_one_batch(batch_x, batch_y):
        optimizer.zero_grad()
        logits = model(batch_x)
        loss = F.cross_entropy(logits, batch_y)
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    elastic_train = controller.elastic_run(train_one_batch)

    def run(batch):
        bx = torch.tensor(np.stack([b[0] for b in batch])).to(device)
        by = torch.tensor(np.asarray([b[1] for b in batch],
                                     dtype=np.int64)).to(device)
        return elastic_train(bx, by)

    losses = []
    batch = []
    try:
        with controller.scope():
            while True:
                try:
                    batch.append(dataset[0])
                except IndexError:
                    break
                if len(batch) == batch_size:
                    losses.append(run(batch))
                    batch = []
            if batch:
                losses.append(run(batch))
    finally:
        dataset.stop()
    logger.info("torch elastic loop done on %s: %d batches", device,
                len(losses))
    return (losses[-1] if losses else float("nan")), len(losses)
