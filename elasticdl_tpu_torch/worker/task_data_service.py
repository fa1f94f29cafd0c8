"""Turns the master's task stream into batches of ndarrays.

Parity with elasticdl/python/worker/task_data_service.py:24-134, minus
tf.data: records stream from the data reader, the zoo's ``feed`` packs them
into numpy batches sized for the jitted step.
"""


class TaskDataService:
    def __init__(self, data_reader, feed_fn):
        self._reader = data_reader
        self._feed = feed_fn

    def record_stream(self, task):
        return self._reader.read_records(task)

    def batch_stream(self, task, batch_size):
        """Yield (features, labels, record_count) batches for one task."""
        buffer = []
        for record in self._reader.read_records(task):
            buffer.append(record)
            if len(buffer) == batch_size:
                features, labels = self._feed(buffer)
                yield features, labels, len(buffer)
                buffer = []
        if buffer:
            features, labels = self._feed(buffer)
            yield features, labels, len(buffer)
