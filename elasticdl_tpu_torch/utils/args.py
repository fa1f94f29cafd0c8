"""Command-line flags of the port's entry points (counterpart of
``elasticdl_tpu/utils/args.py``).  Flags keep the JAX package's names
and defaults; the serving parser holds only the flags the port's
server implements so far."""

import argparse


def build_serving_parser():
    parser = argparse.ArgumentParser("elasticdl_tpu_torch.serving.server")
    parser.add_argument("--export_dir", required=True,
                        help="one export dir, or a TF-Serving-style "
                             "versioned base <base>/<N>/")
    parser.add_argument("--model_name", default=None)
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--poll_interval", type=float, default=2.0,
                        help="seconds between version re-scans of a "
                             "TF-Serving-style <base>/<N>/ export dir")
    return parser


def parse_opt_args(opt_args):
    """Parse ``k=v;k=v`` strings; numbers become floats."""
    out = {}
    for piece in opt_args.split(";"):
        piece = piece.strip()
        if not piece:
            continue
        key, _, value = piece.partition("=")
        try:
            out[key.strip()] = float(value)
        except ValueError:
            out[key.strip()] = value.strip()
    return out
