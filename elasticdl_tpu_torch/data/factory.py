"""Data reader factory (parity:
elasticdl/python/data/reader/data_reader_factory.py:23-79)."""

import os


def create_data_reader(data_origin, records_per_shard=256, **kwargs):
    if data_origin.startswith("synthetic_mnist"):
        from elasticdl_tpu_torch.data.reader import ArrayDataReader
        from elasticdl_tpu_torch.models import mnist

        _, _, n = data_origin.partition(":")
        xs, ys = mnist.synthetic_data(n=int(n) if n else 2048)
        return ArrayDataReader(
            (xs, ys), records_per_shard=records_per_shard
        )
    if data_origin.startswith("synthetic_cifar10"):
        from elasticdl_tpu_torch.data.reader import ArrayDataReader
        import numpy as np

        _, _, n = data_origin.partition(":")
        n = int(n) if n else 2048
        rng = np.random.RandomState(0)
        xs = rng.rand(n, 32, 32, 3).astype(np.float32)
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        return ArrayDataReader((xs, ys), records_per_shard=records_per_shard)
    if data_origin.startswith("synthetic_lm"):
        from elasticdl_tpu_torch.data.reader import ArrayDataReader
        import numpy as np

        # "synthetic_lm[:n[:seq_len[:vocab]]]"
        parts = data_origin.split(":")
        n = int(parts[1]) if len(parts) > 1 else 2048
        seq_len = int(parts[2]) if len(parts) > 2 else 128
        vocab = int(parts[3]) if len(parts) > 3 else 1024
        rng = np.random.RandomState(0)
        # learnable structure: arithmetic token sequences mod vocab
        starts = rng.randint(0, vocab, size=n)
        steps = rng.randint(1, 7, size=n)
        toks = (
            starts[:, None] + steps[:, None] * np.arange(seq_len)[None]
        ) % vocab
        return ArrayDataReader(
            (toks.astype(np.int32),), records_per_shard=records_per_shard
        )
    if data_origin.startswith("synthetic_ctr"):
        from elasticdl_tpu_torch.data.reader import ArrayDataReader
        from elasticdl_tpu_torch.models import deepfm

        _, _, n = data_origin.partition(":")
        dense, ids, labels = deepfm.synthetic_data(
            n=int(n) if n else 4096
        )
        return ArrayDataReader(
            (dense, ids, labels), records_per_shard=records_per_shard
        )
    if data_origin.startswith("tokens:"):
        # "tokens:<path>:<seq_len>[:<dtype>]" — flat binary token file
        # (GPT-style pretraining data), memory-mapped windows.
        import numpy as np

        from elasticdl_tpu_torch.data.token_reader import TokenFileDataReader

        parts = data_origin.split(":")
        if len(parts) < 3:
            raise ValueError(
                "tokens origin needs tokens:<path>:<seq_len>[:<dtype>]")
        dtype = parts[3] if len(parts) > 3 else "uint16"
        if dtype not in ("uint16", "uint32"):
            # A float or typo'd dtype would memmap the bytes as
            # garbage and train on noise with no error.
            raise ValueError(
                "tokens dtype must be uint16 or uint32, got %r"
                % dtype)
        return TokenFileDataReader(
            parts[1], seq_len=int(parts[2]), dtype=np.dtype(dtype),
            records_per_shard=records_per_shard,
        )
    if data_origin.startswith("imagefolder:"):
        # "imagefolder:<root>[:<image_size>[:augment]]" —
        # ImageNet-layout dirs; the optional literal "augment" enables
        # training-time random crop + horizontal flip.
        from elasticdl_tpu_torch.data.image_folder import ImageFolderDataReader

        parts = data_origin.split(":")
        root = parts[1]
        image_size = int(parts[2]) if len(parts) > 2 else 224
        augment = len(parts) > 3 and parts[3] == "augment"
        if (len(parts) > 3 and not augment) or len(parts) > 4:
            raise ValueError(
                "imagefolder options %r not understood (only a "
                "single 'augment')" % (parts[3:],))
        return ImageFolderDataReader(
            root, image_size=image_size,
            records_per_shard=records_per_shard, augment=augment,
        )
    if data_origin.endswith(".csv"):
        from elasticdl_tpu_torch.data.reader import TextDataReader

        return TextDataReader(
            data_origin, records_per_task=records_per_shard,
            skip_header=kwargs.get("skip_header", False),
        )
    if os.path.isdir(data_origin):
        from elasticdl_tpu_torch.data.reader import RecioDataReader
        from elasticdl_tpu_torch.data.recio_gen import decode_xy

        return RecioDataReader(
            data_origin, decode_fn=kwargs.get("decode_fn", decode_xy)
        )
    if data_origin.endswith(".db") or data_origin.startswith("sql:"):
        from elasticdl_tpu_torch.data.sql_reader import SQLTableDataReader

        spec = data_origin[4:] if data_origin.startswith("sql:") \
            else data_origin
        database, _, table = spec.partition("#")
        return SQLTableDataReader(
            database, table or "samples",
            records_per_shard=records_per_shard,
        )
    raise ValueError("cannot infer a data reader for %r" % data_origin)
