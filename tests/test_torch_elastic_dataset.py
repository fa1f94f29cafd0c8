"""The port's ``ElasticDataset`` (elasticdl_tpu_torch/api/dataset.py) over
the port's ``RecordIndexService`` and master: the port of
tests/test_elastic_dataset.py, each of its two tests under its reference
name, and the same source through both packages' datasets, each against
its own package's master.  Record indices are exact, so no tolerance
applies."""

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from elasticdl_tpu_torch.api.dataset import ElasticDataset
from tests.test_torch_elastic_controller import (
    create_master,
    create_master_client,
)


def drain(dataset):
    """Every record the dataset yields until the job ends, one at a
    time, each reported done."""
    seen = []
    while True:
        try:
            seen.append(dataset[0])
        except IndexError:
            return seen
        dataset.report_batch_done(1)


def test_record_index_service_covers_all_records():
    master = create_master([("f", 0, 40)], records_per_task=16)
    dataset = None
    try:
        mc = create_master_client(master)
        source = list(range(1000, 1040))
        dataset = ElasticDataset(source, mc, batch_size=8)
        seen = drain(dataset)
        assert sorted(v - 1000 for v in seen) == list(range(40))
        assert master.task_manager.finished()
        assert len(dataset) > 2 ** 62      # sys.maxsize: decided by the master
    finally:
        if dataset is not None:
            dataset.stop()
        master.stop()


def test_elastic_dataset_with_torch_dataloader():
    master = create_master([("f", 0, 64)], records_per_task=16)
    elastic = None
    try:
        mc = create_master_client(master)
        xs = np.arange(64, dtype=np.float32)

        class Source:
            def __getitem__(self, i):
                return xs[i]

        elastic = ElasticDataset(Source(), mc, batch_size=8)

        class TorchView(Dataset):
            def __len__(self):
                return 64  # upper bound for the sampler

            def __getitem__(self, i):
                return torch.tensor(elastic[i])

        loader = DataLoader(TorchView(), batch_size=8, num_workers=0)
        total = []
        try:
            for batch in loader:
                total.extend(batch.tolist())
                elastic.report_batch_done(len(batch))
        except IndexError:
            pass
        assert sorted(int(v) for v in total) == list(range(64))
    finally:
        if elastic is not None:
            elastic.stop()
        master.stop()


def test_same_source_same_records_as_the_jax_package():
    """One source, two jobs of the same shards (three tasks, the last
    short): the port's dataset over the port's master and the JAX
    package's over its own yield the same records in the same order."""
    from elasticdl_tpu.api.dataset import ElasticDataset as JaxDataset
    from tests.test_utils import create_master as jax_master
    from tests.test_utils import create_master_client as jax_client

    source = [("rec", i, float(i) * 0.5) for i in range(37)]
    got = {}
    for name, make_master, make_client, cls in (
            ("port", create_master, create_master_client, ElasticDataset),
            ("jax", jax_master, jax_client, JaxDataset)):
        master = make_master(training_shards=[("f", 0, 37)],
                             records_per_task=16)
        dataset = None
        try:
            dataset = cls(source, make_client(master), batch_size=4)
            got[name] = drain(dataset)
            assert master.task_manager.finished(), name
        finally:
            if dataset is not None:
                dataset.stop()
            master.stop()
    assert got["port"] == got["jax"]
    assert sorted(got["port"]) == source
