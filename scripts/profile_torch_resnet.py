#!/usr/bin/env python3
"""Where a ResNet-50 forward or training step of the PyTorch/CUDA port
spends the card's time: device time by kernel, grouped by layer, and the
device's busy share of the wall time.  Needs one NVIDIA card.  Run from
the root of a checkout:

    python3 scripts/profile_torch_resnet.py [--batch 4 32] [--steps 10]
    python3 scripts/profile_torch_resnet.py --train [--bf16] --batch 32

The model is ResNet-50 at 224x224x3, 1000 classes, seeded random
weights, float32 with TF32 off, GroupNorm on the port's CUDA kernels.
By default it profiles the served forward (inference mode).  With
``--train`` it profiles training steps of the port's CollectiveTrainer
(SGD with momentum, forward, backward and update; ``--bf16`` runs the
forward under bf16 autocast, as bench.py's setting does).
``torch.profiler`` traces ``--steps`` synchronised forwards or steps
after two warm-up ones.  Prints one JSON object per batch size as its
last lines.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from elasticdl_tpu_torch.models import resnet  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import group_norm as gn  # noqa: E402
from elasticdl_tpu_torch.worker.collective_trainer import (  # noqa: E402
    CollectiveTrainer)

# Kernel-name fragments -> layer, first match wins.  cuDNN's own
# NHWC <-> NCHW transposes around a conv count as "conv layout".  The
# GroupNorm passes of both designs (the earlier three and four launches
# per call, and the cluster kernels with the backward's batch sum), so
# one script profiles either.
GN_FWD = ("gn_partial_stats", "gn_merge", "gn_normalize", "gn_fwd_cluster")
GN_BWD = ("gn_bwd_partial", "gn_bwd_merge", "gn_bwd_affine", "gn_bwd_dx",
          "gn_bwd_cluster")
GROUPS = [
    ("group_norm backward", GN_BWD),
    ("group_norm", GN_FWD),
    ("optimizer", ("multi_tensor", "foreach")),
    ("conv layout", ("nchwToNhwc", "nhwcToNchw")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fft", "complex",
              "sm90_", "cutlass", "xmma", "gemm")),
    ("pad/copy", ("pad", "copy", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "add", "relu",
                     "threshold")),
    ("pool/mean", ("pool", "reduce", "mean")),
]


def layer_of(name):
    for layer, keys in GROUPS:
        if any(k in name for k in keys):
            return layer
    return "other"


def device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def profile(step, batch, steps):
    """Trace ``steps`` calls of ``step`` (each synchronised) after two
    warm-up calls."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    gn.LAUNCHES = gn.BWD_LAUNCHES = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    if not kernels:
        raise SystemExit("torch.profiler saw no device time")
    by_layer, gn_passes = {}, {}
    for name, us in kernels.items():
        layer = layer_of(name)
        by_layer[layer] = by_layer.get(layer, 0.0) + us / steps / 1e3
        for p in GN_FWD + GN_BWD:
            if p in name:
                gn_passes[p] = gn_passes.get(p, 0.0) + us / steps / 1e3
                break
    busy_ms = sum(kernels.values()) / steps / 1e3
    wall_ms = wall_us / steps / 1e3
    return {
        "batch": batch, "steps": steps,
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_by_layer": dict(sorted(by_layer.items(),
                                          key=lambda kv: -kv[1])),
        "group_norm_ms_by_pass": gn_passes,
        "group_norm_launches_per_call": [gn.LAUNCHES / steps,
                                         gn.BWD_LAUNCHES / steps],
        "top_kernels_ms": {k[:80]: v / steps / 1e3 for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:8]},
    }


def seeded(spec, module):
    rng = np.random.RandomState(0)
    return spec.params_from_jax({
        name: (rng.randn(*v.shape) * (np.sqrt(2.0 / np.prod(v.shape[:-1]))
                                      if name.endswith("kernel") else 0.1)
               + (1.0 if name.endswith("scale") else 0.0)).astype(np.float32)
        for name, v in spec.params_to_jax(module).items()})


def images(batch):
    return torch.from_numpy(np.random.RandomState(2).rand(
        batch, 224, 224, 3).astype(np.float32)).cuda()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[4, 32])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--train", action="store_true",
                        help="profile training steps, not forwards")
    parser.add_argument("--bf16", action="store_true",
                        help="with --train: bf16 autocast compute")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = resnet.model_spec("resnet50", learning_rate=1e-3)
    for batch in args.batch:
        x = images(batch)
        if args.train:
            trainer = CollectiveTrainer(spec, batch_size=batch,
                                        device="cuda",
                                        use_bf16_compute=args.bf16)
            trainer.set_params(seeded(spec, trainer.module))
            y = torch.from_numpy(np.random.RandomState(3).randint(
                0, 1000, size=batch).astype(np.int32)).cuda()

            def step():
                trainer.train_minibatch(x, y)
        else:
            module = spec.init_fn("cuda")
            module.load_state_dict(seeded(spec, module))

            def step():
                with torch.inference_mode():
                    module(x)
        result = profile(step, batch, args.steps)
        result["mode"] = ("train, bf16 autocast" if args.train and args.bf16
                          else "train, float32" if args.train
                          else "forward, float32")
        print(json.dumps(result))


if __name__ == "__main__":
    main()
