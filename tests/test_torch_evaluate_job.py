"""The port's evaluate job (``--job_type evaluate``), driven as a user
drives it: ``python -m elasticdl_tpu_torch.master.main`` with one worker
process on the CPU, after a train job of the same CLI wrote a
checkpoint (tests/test_torch_job_types.py's fixture and harness).

The master's evaluation service creates the job's evaluation tasks at
version 0 and logs the metric when the last one reports; that accuracy
equals the port's ``utils.metrics.Accuracy`` over the in-process
forward of the same records from the same checkpoint (the log rounds to
6 decimals; 320 records make the accuracy a multiple of 1/320).
"""

import re

import pytest

from elasticdl_tpu_torch.models import mnist
from tests.test_torch_job_types import (  # noqa: F401
    Job, checkpoint, job_env, records_and_forward)

EVAL_ORIGIN = "synthetic_mnist:320"
EVAL_ARGS = ["--model_zoo", "mnist", "--batch_size", "32",
             "--num_workers", "1", "--num_minibatches_per_task", "2"]
EVAL_TASKS = 5


def test_evaluate_job_logs_the_in_process_accuracy(job_env,  # noqa: F811
                                                   checkpoint):  # noqa: F811
    job = Job(EVAL_ARGS + ["--job_type", "evaluate",
                           "--data_origin", EVAL_ORIGIN,
                           "--checkpoint_dir", checkpoint], *job_env)
    assert job.finish(timeout=180) == 0, job.log
    assert "evaluation job created at version 0 (%d tasks)" % EVAL_TASKS \
        in job.log, job.log
    logged = re.findall(r"evaluation @ version 0: \{'accuracy': "
                        r"(?:np\.float64\()?([0-9.]+)\)?\}", job.log)
    assert len(logged) == 1, job.log
    finished = next(line for line in job.log.splitlines()
                    if "job finished:" in line)
    # Task type 1 is EVALUATION (proto/elastic_pb2.py).
    assert "'completed': {0: 0, 1: %d, 2: 0, 4: 0}" % EVAL_TASKS in (
        finished), finished
    _, ys, outs = records_and_forward(EVAL_ORIGIN, checkpoint)
    metric = mnist.model_spec().eval_metrics_fn()["accuracy"]
    metric.update(outs, ys)
    want = float(metric.result())
    assert 0.0 < want < 1.0
    assert float(logged[0]) == pytest.approx(want, abs=1e-6)
