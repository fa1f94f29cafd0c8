from elasticdl_tpu_torch.aggregation.aggregator import (  # noqa: F401
    ModelAggregator,
)
