"""Dataset -> recio converters (reference: data/recordio_gen/*).

Records serialize as npz-encoded feature dicts; RecioDataReader decodes
them with ``decode_record``.
"""

import io
import os

import numpy as np

from elasticdl_tpu_torch.data.recio import RecioWriter


def encode_record(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def decode_record(payload):
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def decode_xy(payload):
    """Decoder for (x, y) supervised records."""
    d = decode_record(payload)
    return d["x"], d["y"]


def convert_arrays(output_dir, arrays, records_per_file=2048,
                   names=("x", "y")):
    """Write parallel arrays into sharded recio files (one per shard)."""
    os.makedirs(output_dir, exist_ok=True)
    n = len(arrays[0])
    file_index = 0
    written = []
    pos = 0
    while pos < n:
        end = min(pos + records_per_file, n)
        path = os.path.join(
            output_dir, "data-%05d.recio" % file_index
        )
        with RecioWriter(path) as w:
            for i in range(pos, end):
                w.write(encode_record(
                    **{name: a[i] for name, a in zip(names, arrays)}
                ))
        written.append(path)
        file_index += 1
        pos = end
    return written


def convert_synthetic_mnist(output_dir, n=4096, records_per_file=1024):
    from elasticdl_tpu_torch.models.mnist import synthetic_data

    xs, ys = synthetic_data(n=n)
    return convert_arrays(output_dir, (xs, ys),
                          records_per_file=records_per_file)


def convert_csv(csv_path, output_dir, label_column=-1,
                records_per_file=2048, skip_header=False,
                numeric_columns=None):
    """CSV -> recio (x, y) records — the census/heart converter shape
    (reference census_recordio_gen.py / heart_recordio_gen.py): feature
    columns become a float vector, the label column an int32 scalar.

    numeric_columns: indices of columns to keep as features; default =
    every column except the label.  Non-numeric values hash to a float
    bucket (the reference pre-hashes categoricals before packing).
    """
    import csv as _csv

    from elasticdl_tpu_torch.utils.hashing import string_to_id

    rows = []
    with open(csv_path, newline="") as f:
        reader = _csv.reader(f)
        if skip_header:
            next(reader, None)
        for row in reader:
            if row:
                rows.append(row)
    if not rows:
        raise ValueError("no rows in %s" % csv_path)
    ncols = len(rows[0])
    for i, row in enumerate(rows):
        if len(row) != ncols:
            raise ValueError(
                "ragged CSV: row %d has %d columns, expected %d"
                % (i + 1, len(row), ncols)
            )
    if not -ncols <= label_column < ncols:
        raise ValueError(
            "label_column %d out of range for %d columns"
            % (label_column, ncols)
        )
    label_column = label_column % ncols
    if numeric_columns is None:
        numeric_columns = [i for i in range(ncols) if i != label_column]

    import math

    def to_float(v):
        try:
            x = float(v)
        except ValueError:
            return float(string_to_id(v, 1 << 16))
        # literal "nan"/"inf" strings are categorical markers, not
        # features — bucket them like any other string
        return x if math.isfinite(x) else float(string_to_id(v, 1 << 16))

    xs = np.asarray(
        [[to_float(row[i]) for i in numeric_columns] for row in rows],
        np.float32,
    )
    # Labels: all-numeric passes through; all-categorical ('>50K' /
    # '<=50K') gets stable vocabulary ids.  A MIX is ambiguous (one
    # stray '?' would silently renumber every numeric class), so it
    # errors instead of guessing.
    raw_labels = [row[label_column] for row in rows]

    def numeric_label(v):
        try:
            return int(float(v))
        except ValueError:
            return None

    parsed = [numeric_label(v) for v in raw_labels]
    if all(p is not None for p in parsed):
        ys = np.asarray(parsed, np.int32)
    elif all(p is None for p in parsed):
        vocab = {v: i for i, v in enumerate(sorted(set(raw_labels)))}
        ys = np.asarray([vocab[v] for v in raw_labels], np.int32)
    else:
        bad = sorted({
            v for v, p in zip(raw_labels, parsed) if p is None
        })[:5]
        raise ValueError(
            "label column mixes numeric and non-numeric values "
            "(e.g. %s); clean the data or choose another column" % bad
        )
    return convert_arrays(output_dir, (xs, ys),
                          records_per_file=records_per_file)


def convert_ctr(output_dir, n=65536, records_per_file=4096, **kwargs):
    """Synthetic CTR (dense, ids, label) records — the frappe/dac_ctr
    converter shape (reference frappe_recordio_gen.py)."""
    from elasticdl_tpu_torch.models.deepfm import synthetic_data

    dense, ids, labels = synthetic_data(n=n, **kwargs)
    return convert_arrays(
        output_dir, (dense, ids, labels),
        records_per_file=records_per_file, names=("dense", "ids", "y"),
    )
