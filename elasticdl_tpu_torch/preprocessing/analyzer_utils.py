"""Env-var-driven dataset statistics.

Parity with elasticdl_preprocessing/utils/analyzer_utils.py:23-50+: an
offline analyzer (or the job submitter) exports per-feature statistics into
the environment; zoo feeds read them to configure preprocessing layers.
Variable scheme: ``_EDL_TPU_<FEATURE>_<STAT>``.
"""

import json
import os

_PREFIX = "_EDL_TPU_"


def _get(feature, stat, default=None, cast=float):
    key = "%s%s_%s" % (_PREFIX, feature.upper(), stat.upper())
    value = os.environ.get(key)
    if value is None:
        return default
    return cast(value)


def get_min(feature, default=None):
    return _get(feature, "min", default)


def get_max(feature, default=None):
    return _get(feature, "max", default)


def get_mean(feature, default=None):
    return _get(feature, "avg", default)


def get_stddev(feature, default=None):
    return _get(feature, "stddev", default)


def get_distinct_count(feature, default=None):
    return _get(feature, "count_distinct", default, cast=int)


def get_bucket_boundaries(feature, default=None):
    value = _get(feature, "bucket_boundaries", None, cast=str)
    if value is None:
        return default
    return json.loads(value)


def get_vocabulary(feature, default=None):
    value = _get(feature, "vocabulary", None, cast=str)
    if value is None:
        return default
    return json.loads(value)


def set_stats(feature, **stats):
    """Export stats into the env (what the analyzer job does)."""
    for stat, value in stats.items():
        key = "%s%s_%s" % (_PREFIX, feature.upper(), stat.upper())
        if isinstance(value, (list, dict)):
            value = json.dumps(value)
        os.environ[key] = str(value)
