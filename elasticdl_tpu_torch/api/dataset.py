"""Elastic map-style datasets (counterpart of
``elasticdl_tpu/api/dataset.py``, copied; the import differs;
reference: elasticai_api/pytorch/dataset.py).

``ElasticDataset`` wraps any indexable source so that ``__getitem__``
consumes master-assigned record indices instead of the loader's own
sampler — the trick that makes a stock PyTorch training loop elastic:
whatever records a dead worker was holding are re-queued by the master
and handed to the surviving workers.  ``__len__`` is reported as a very
large number (the reference uses sys.maxsize) because the true amount of
data a given worker will see is decided dynamically.
"""

import sys

from elasticdl_tpu_torch.worker.data_shard_service import RecordIndexService


class ElasticDataset:
    def __init__(self, source, master_client, batch_size=1):
        """source: anything supporting source[i] for global record i."""
        self._source = source
        self.shard_service = RecordIndexService(
            master_client, batch_size=batch_size
        )

    def __len__(self):
        return sys.maxsize

    def __getitem__(self, _index):
        """Ignores the sampler's index; pulls the next dynamic index."""
        index = self.shard_service.fetch_record_index()
        if index is None:
            raise IndexError("no more records (job finished)")
        return self._source[index]

    def report_batch_done(self, batch_size=None):
        self.shard_service.report_batch_done(batch_size)

    def stop(self):
        self.shard_service.stop()
