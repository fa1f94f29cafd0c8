"""Cached, formatter-standardized loggers with a process identity
(counterpart of ``elasticdl_tpu/utils/logging.py``, copied).

Parity with the reference's logger registry
(elasticdl/python/common/log_utils.py:20-43), plus a process-identity
prefix: every process in a drill (master, PS shards, workers, serving
replicas, router) logs ``[role-rank@gN]`` so interleaved multi-process
logs are attributable without grepping ports.  Identity is set once by
each entrypoint via ``set_process_identity`` and picked up by every
already-created logger (the formatter reads it at format time); the
restart GENERATION half can be updated later, when a PS shard learns
its incarnation.
"""

import logging
import os
import sys

# Mutable on purpose: the formatter reads it per record, so identity
# set (or generation-bumped) after loggers exist applies everywhere.
_identity = {"label": ""}


def set_process_identity(role, rank=None, generation=None):
    """``role``: master/worker/ps/serving/router; ``rank``: worker id
    or PS shard id; ``generation``: restart incarnation (PS shards,
    restarted masters).  Also the identity the tracing plane stamps on
    every flight-recorder event (callers pass the same values to
    ``tracing.configure``)."""
    label = str(role)
    if rank is not None:
        label += "-%s" % rank
    if generation is not None:
        label += "@g%s" % generation
    _identity["label"] = label
    return label


def get_process_identity():
    return _identity["label"]


class _IdentityFormatter(logging.Formatter):
    def format(self, record):
        label = _identity["label"]
        record.identity = ("[%s] " % label) if label else ""
        return super().format(record)


_FORMAT = (
    "[%(asctime)s] [%(levelname)s] %(identity)s"
    "[%(name)s:%(lineno)d:%(funcName)s] %(message)s"
)

_loggers = {}


def get_logger(name, level=None):
    if name in _loggers:
        return _loggers[name]
    logger = logging.getLogger(name)
    logger.setLevel(level or os.environ.get("ELASTICDL_TPU_LOG_LEVEL", "INFO"))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_IdentityFormatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    _loggers[name] = logger
    return logger


default_logger = get_logger("elasticdl_tpu_torch")
