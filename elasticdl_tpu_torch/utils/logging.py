"""Cached, formatter-standardized loggers (counterpart of
``elasticdl_tpu/utils/logging.py``; the process-identity prefix of the
JAX package comes with the multi-process tiers of later slices)."""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(lineno)d:%(funcName)s] %(message)s"
)

_loggers = {}


def get_logger(name, level=None):
    if name in _loggers:
        return _loggers[name]
    logger = logging.getLogger(name)
    logger.setLevel(level or os.environ.get("ELASTICDL_TPU_LOG_LEVEL", "INFO"))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    _loggers[name] = logger
    return logger
