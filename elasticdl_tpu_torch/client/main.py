"""The ``elasticdl-tpu-torch`` CLI (parity: elasticdl_client/main.py:28-103;
counterpart of ``elasticdl_tpu/client/main.py``).

Subcommands:
  zoo init | zoo build | zoo push     — model-zoo project tooling
  serve                               — HTTP model server over a
                                      servable export (serving/server)
  inspect PATH                        — summarize an export or a
                                      checkpoint directory
  train | evaluate | predict          — submit a job:
      --platform local  (default)     run the port's master (and its
                                      managed worker/PS processes) on
                                      this host; ``--jobs_spec`` runs a
                                      multi-tenant pool
      --platform k8s                  CREATE the master pod + service on
                                      the cluster via the k8s API
                                      (reference elasticdl_client/
                                      api.py:199-256); pass --output
                                      PATH|- to render the manifests for
                                      kubectl instead of submitting

Where it differs from the reference, besides the package it drives:
 - ``zoo init`` scaffolds a torch zoo module to the port's ``ModelSpec``
   contract (``models/spec.py``), and a Dockerfile that installs torch
   built for CUDA instead of ``jax[tpu]``.  Text only: nothing builds or
   pulls an image until ``zoo build``;
 - ``inspect`` reads the port's exports (``serving/export.py``: it also
   names the servable program, and summarizes a frame-carrier export by
   its ``model.frame``) and checkpoints: the latest loadable version is
   read through ``CheckpointSaver.load_shard`` as one shard, so a
   parameter-server checkpoint (embedding tables beside the dense
   arrays) is summarized too, where the port's dense ``load`` refuses it.
"""

import argparse
import os
import subprocess
import sys

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _add_job_args(parser):
    parser.add_argument("--platform", default="local",
                        choices=["local", "k8s"])
    parser.add_argument("--image", default="elasticdl-tpu:latest",
                        help="container image (k8s platform)")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--output", default=None,
                        help="instead of creating the master pod via the "
                             "k8s API, render its manifests to this path "
                             "('-' = stdout) for kubectl")
    parser.add_argument("--master_resource_request",
                        default="cpu=1,memory=2Gi",
                        help="k8s resources for the master pod, "
                             "'cpu=1,memory=2Gi,...'")
    parser.add_argument("--cluster_spec", default="",
                        help="dotted module with patch_pod/patch_service "
                             "hooks applied to every manifest")


def _split_args(argv):
    """Separate CLI-level args from master-level passthrough args."""
    cli = argparse.ArgumentParser("elasticdl-tpu-torch job")
    _add_job_args(cli)
    cli_args, rest = cli.parse_known_args(argv)
    return cli_args, rest


def _run_job(job_type, argv, core_api=None):
    cli_args, master_argv = _split_args(argv)
    master_argv = ["--job_type", job_type] + master_argv
    if cli_args.platform == "local":
        from elasticdl_tpu_torch.master.main import main as master_main

        return master_main(master_argv)
    from elasticdl_tpu_torch.client import k8s_submit
    from elasticdl_tpu_torch.client.k8s_renderer import (
        parse_resource_string,
    )

    # parse_known_args consumed --namespace/--image/--cluster_spec above,
    # but the IN-CLUSTER master needs them too (worker pods in the same
    # namespace/image, same patch hooks) — forward the parsed values.
    master_argv = master_argv + [
        "--namespace", cli_args.namespace,
        "--image", cli_args.image,
        "--cluster_spec", cli_args.cluster_spec,
    ]
    if not any(a == "--worker_backend" or a.startswith("--worker_backend=")
               for a in master_argv):
        # A cluster submission wants worker PODS; without this the
        # in-cluster master would run workers as subprocesses inside its
        # own cpu=1 pod (worker_backend defaults to "process").  An
        # explicit --worker_backend in the job args still wins.
        master_argv += ["--worker_backend", "k8s"]
    resources = parse_resource_string(cli_args.master_resource_request)
    if cli_args.output is not None:
        manifest = k8s_submit.render_manifests(
            master_argv, image=cli_args.image,
            namespace=cli_args.namespace, resources=resources,
            cluster_spec=cli_args.cluster_spec,
        )
        if cli_args.output == "-":
            print(manifest)
        else:
            with open(cli_args.output, "w") as f:
                f.write(manifest)
            logger.info("wrote manifest to %s", cli_args.output)
        return 0
    k8s_submit.submit_job(
        master_argv, image=cli_args.image, namespace=cli_args.namespace,
        resources=resources, cluster_spec=cli_args.cluster_spec,
        core_api=core_api,
    )
    return 0


# -- zoo tooling --------------------------------------------------------------

_ZOO_TEMPLATE = '''"""Model zoo module — exports model_spec(**kwargs)."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.models.spec import (
    ModelSpec,
    init_flax_defaults_,
    params_from_jax,
    params_to_jax,
)
from elasticdl_tpu_torch.utils import metrics
from elasticdl_tpu_torch.utils.device import resolve_device


class Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(8, 64)
        self.Dense_1 = nn.Linear(64, 2)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def feed(records):
    xs = np.stack([np.asarray(r[0], np.float32) for r in records])
    ys = np.asarray([int(r[1]) for r in records], np.int32)
    return xs, ys


def loss_fn(logits, labels):
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def model_spec(learning_rate=1e-3):
    def init_fn(device=None, seed=0):
        return init_flax_defaults_(Model(), seed).to(
            resolve_device(device))

    return ModelSpec(
        name="my_model",
        init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x),
        feed=feed,
        params_from_jax=params_from_jax,
        params_to_jax=params_to_jax,
        input_shape=(8,),
        loss_fn=loss_fn,
        optimizer=lambda params: torch.optim.Adam(params,
                                                  lr=learning_rate),
        eval_metrics_fn=lambda: {"accuracy": metrics.Accuracy()},
    )
'''

_DOCKERFILE_TEMPLATE = """# Generated by `elasticdl-tpu-torch zoo init`
FROM python:3.12-slim
RUN pip install --index-url https://download.pytorch.org/whl/cu128 torch \\
 && pip install grpcio protobuf numpy
COPY . /model_zoo
ENV PYTHONPATH=/model_zoo
"""


def _zoo_init(args):
    os.makedirs(args.path, exist_ok=True)
    model_file = os.path.join(args.path, "my_model.py")
    if not os.path.exists(model_file):
        with open(model_file, "w") as f:
            f.write(_ZOO_TEMPLATE)
    with open(os.path.join(args.path, "Dockerfile"), "w") as f:
        f.write(_DOCKERFILE_TEMPLATE)
    logger.info("initialized model zoo at %s", args.path)
    return 0


def _zoo_build(args):
    cmd = ["docker", "build", "-t", args.image, args.path]
    logger.info("running: %s", " ".join(cmd))
    return subprocess.call(cmd)


def _zoo_push(args):
    cmd = ["docker", "push", args.image]
    logger.info("running: %s", " ".join(cmd))
    return subprocess.call(cmd)


def _fmt_bytes(n):
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return "%.1f %s" % (n, unit)
        n /= 1024.0


def _inspect_npz(npz_path):
    """Header-only scan of an export's ``model.npz``: shapes/dtypes come
    from each member's npy header, so inspecting a multi-GB export never
    materializes an array.  int8-quantized entries count at float32 size
    in the in-memory figure (the loader dequantizes at load)."""
    import zipfile

    import numpy as np

    total = 0
    n_params = 0
    tables = {}
    with zipfile.ZipFile(npz_path) as zf:
        for info in zf.infolist():
            key = info.filename[:-4]  # strip ".npy"
            with zf.open(info) as member:
                np.lib.format.read_magic(member)
                shape, _f, dtype = (
                    np.lib.format.read_array_header_1_0(member))
            nbytes = int(np.prod(shape)) * dtype.itemsize
            if key.startswith(("q8/", "q8emb/")):
                nbytes *= 4  # dequantized to float32 in memory
            total += nbytes
            if key.startswith("emb_ids/"):
                tables[key[len("emb_ids/"):]] = int(shape[0])
            elif not key.startswith(
                ("emb_vals/", "q8emb/", "q8embscale/", "q8scale/")
            ):
                n_params += 1
    print("  parameters: %d arrays, weights file %s on disk"
          % (n_params, _fmt_bytes(os.path.getsize(npz_path))))
    print("  in-memory (dequantized): %s" % _fmt_bytes(total))
    for name, rows in sorted(tables.items()):
        print("  table %s: %d rows" % (name, rows))


def _inspect_export(target, versions):
    import json

    with open(os.path.join(target, "manifest.json")) as f:
        manifest = json.load(f)
    print("servable export: %s" % target)
    if versions:
        print("  versions on disk: %s (latest shown)" % versions)
    for key in ("format", "model_name", "version",
                "polymorphic_batch", "platforms"):
        print("  %s: %s" % (key, manifest.get(key)))
    quantized = manifest.get("quantized_int8") or []
    if quantized:
        print("  int8-quantized: %s" % ", ".join(quantized))
    program = manifest.get("program")
    if program:
        print("  program: %s, %s" % (program, _fmt_bytes(
            os.path.getsize(os.path.join(target, program)))))
    npz_path = os.path.join(target, "model.npz")
    if os.path.isfile(npz_path):
        _inspect_npz(npz_path)
    else:
        frame = os.path.join(target, "model.frame")
        print("  weights: binary frame %s, %s on disk" % (
            os.path.basename(frame), _fmt_bytes(os.path.getsize(frame))))
    return 0


def _inspect(args):
    """Operator tooling: summarize an export or checkpoint directory.

    Detects servable exports (manifest.json, incl. versioned
    ``<base>/<N>/`` layouts — inspects the latest) and checkpoint dirs
    (``version-*``) and prints params/tables/sizes so operators don't
    spelunk npz files by hand.
    """
    from elasticdl_tpu_torch.serving.loader import resolve_export_dir

    path = args.path
    versions = sorted(
        int(e) for e in os.listdir(path)
        if e.isdigit() and os.path.isfile(
            os.path.join(path, e, "manifest.json"))
    ) if os.path.isdir(path) else []  # display only; resolution below
    try:
        target = resolve_export_dir(path)  # the ONE canonical scan
    except (FileNotFoundError, NotADirectoryError):
        target = path
    if os.path.isfile(os.path.join(target, "manifest.json")):
        return _inspect_export(target, versions)

    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    entries = sorted(
        e for e in os.listdir(path) if e.startswith("version-")
    ) if os.path.isdir(path) else []
    if not entries:
        print("nothing to inspect at %s (no manifest.json, no "
              "version-* checkpoints)" % path)
        return 1
    print("checkpoint dir: %s" % path)
    for entry in entries:
        vdir = os.path.join(path, entry)
        shards = sorted(os.listdir(vdir))
        size = sum(
            os.path.getsize(os.path.join(vdir, s)) for s in shards
        )
        print("  %s: %d shard file(s), %s"
              % (entry, len(shards), _fmt_bytes(size)))
    saver = CheckpointSaver(path)
    try:
        # Every file of the newest committed version, read as ONE shard:
        # dense arrays and embedding tables alike.
        dense, embeddings, version = saver.load_shard(None, 0, 1)
        n_opt = sum(1 for k in dense if k.startswith("opt/")
                    or k.startswith("optslot/"))
        print("  latest loadable: version %d — %d dense arrays "
              "(%d optimizer), %d embedding tables"
              % (version, len(dense), n_opt, len(embeddings)))
        for name, (ids, _values) in sorted(embeddings.items()):
            print("  table %s: %d rows" % (name, len(ids)))
    except Exception as e:  # noqa: BLE001 — partial/corrupt dirs
        print("  latest not loadable: %s" % e)
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        "elasticdl-tpu-torch",
        description="elastic deep learning CLI (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command")

    zoo = sub.add_parser("zoo", help="model zoo tooling")
    zoo_sub = zoo.add_subparsers(dest="zoo_command")
    p = zoo_sub.add_parser("init")
    p.add_argument("path", nargs="?", default=".")
    p = zoo_sub.add_parser("build")
    p.add_argument("path", nargs="?", default=".")
    p.add_argument("--image", required=True)
    p = zoo_sub.add_parser("push")
    p.add_argument("--image", required=True)

    for job in ("train", "evaluate", "predict"):
        p = sub.add_parser(
            job, add_help=False,
            help="%s job (plus all master flags)" % job,
        )
        _add_job_args(p)
    sub.add_parser(
        "serve", add_help=False,
        help="serve a servable export over HTTP "
             "(--export_dir DIR [--port P] [--model_name N])",
    )
    p = sub.add_parser(
        "inspect", help="summarize an export or checkpoint directory")
    p.add_argument("path")
    return parser


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    if not argv:
        parser.print_help()
        return 1
    command = argv[0]
    if command in ("train", "evaluate", "predict"):
        return _run_job(command, argv[1:])
    if command == "serve":
        from elasticdl_tpu_torch.serving.server import main as serve_main

        return serve_main(argv[1:])
    args = parser.parse_args(argv)
    if args.command == "inspect":
        return _inspect(args)
    if args.command == "zoo":
        if args.zoo_command == "init":
            return _zoo_init(args)
        if args.zoo_command == "build":
            return _zoo_build(args)
        if args.zoo_command == "push":
            return _zoo_push(args)
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
