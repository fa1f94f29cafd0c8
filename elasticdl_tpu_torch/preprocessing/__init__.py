from elasticdl_tpu_torch.preprocessing import analyzer_utils, feature_column  # noqa: F401
