#!/usr/bin/env python3
"""Where the flagship transformer LM of the PyTorch/CUDA port spends the
card's time, served or trained: device time by kernel group for one
prefill and one decode step, or for one training step, the kernel
launches per call and the device's busy share of the wall time.  Needs
one NVIDIA card.  Run from the root of a checkout:

    python3 scripts/profile_torch_transformer.py [--steps 5]
    python3 scripts/profile_torch_transformer.py --train [--steps 3]
    python3 scripts/profile_torch_transformer.py [--train] \
        --model_params "moe_experts=8;moe_top_k=2"
    python3 scripts/profile_torch_transformer.py --train --zoo lora
    python3 scripts/profile_torch_transformer.py --train --sp 2 [--steps 3]

The model is the flagship config (vocab 32768, dim 1024, 24 layers, 16
heads, 436 M parameters, seeded random weights, bf16 compute) with
attention on the port's flash attention kernel.  It profiles what one
served :predict runs: prefill at batch 8 with a 128-token prompt, the
same at 2048 tokens, and one KV-cache decode step at batch 8 (position
128 of a 256-token cache), each on weights cast to bf16 once, as
``generate`` casts them.  ``torch.profiler`` traces ``--steps``
synchronised calls after two warm-up ones; the untraced wall time of the
same calls is measured apart, since tracing adds host cost.  With
``--train`` it profiles one training step through the port's
CollectiveTrainer at bench_transformer.py's shape instead: batch 8 x
2048, bf16 compute, AdamW, remat=True, dense cross entropy, one batch
repeated.  ``--model_params`` adds zoo settings to the flagship's
(Flagship-MoE: ``moe_experts=8;moe_top_k=2``); ``--zoo lora`` trains
LoRA adapters (rank 8, alpha 16, the attention projections) on a frozen
flagship base.  The weight products are also summed by the op that
launched them (``aten::mm``/``addmm``: the dense projections and the
head; ``aten::bmm`` on a float32 GEMM kernel: an MoE's dispatch and
combine einsums, LoRA's A @ B; on a bf16 one: an MoE's experts), from
the trace's links
from op to kernel (``device_ms_by_matmul_op``).  ``--model_params
"remat=dots"`` (or ``attn``, ``false``) trains under that remat policy
instead of remat=True.  ``--sp N`` (with ``--train``) spawns N ranks
that share the card (``parallel/launch.py``, gloo groups whose transport
stages tensors through host memory) and profiles in each one step of the
port's SPMDTrainer over a ``sp=N`` mesh, attention as ring attention
(B3p); each rank reports, beside the groups, the device time inside
``_partial_stats_bwd`` (the partial's backward in plain PyTorch) and the
host time inside the transport calls (ring shifts, the gradient and loss
all-reduces), each entered after a synchronise, so that work queued
before it is not counted as transport.
Prints the card's name and power limit, then one JSON object per call
(per rank with ``--sp``) as its last lines.
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

from elasticdl_tpu_torch.models import transformer as tfm  # noqa: E402
from elasticdl_tpu_torch.models.spec import load_model_spec  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

LM_PARAMS = ("vocab_size=32768;dim=1024;num_heads=16;num_layers=24;"
             "seq_len=2048;dtype=bfloat16")
LORA_PARAMS = "rank=8;alpha=16"
# The weight products' groups by launching op and dtype (``profile``).
MATMUL_OPS = {("aten::mm", False): "dense projections and head (mm)",
              ("aten::addmm", False): "dense projections and head (mm)",
              ("aten::bmm", True): "f32 bmm (MoE dispatch, combine; LoRA)",
              ("aten::bmm", False): "MoE experts (bf16 bmm)"}
F32_GEMM = ("sgemm", "f32f32_f32f32")    # float32 GEMM kernel names
BATCH, PROMPT, NEW = 8, 128, 128
# Kernel-name fragments -> group, first match wins.
GROUPS = [
    ("flash attention partial (B3p)", ("flash_fwd_wgmma<false>",
                                       "flash_fwd_bf16<128, 1, false>",
                                       "flash_fwd_f32<64, false>",
                                       "flash_fwd_f32<128, false>")),
    ("flash attention (B3)", ("flash_fwd",)),
    ("flash attention dq (B4)", ("bwd_dq_",)),
    ("flash attention dk, dv (B5)", ("bwd_dkv_",)),
    # float32 GEMMs: in the LM, an MoE's dispatch and combine einsums and
    # LoRA's A @ B
    ("matmul, float32 (MoE dispatch, combine; LoRA A @ B)",
     ("sgemm", "f32f32_f32f32")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "gemv", "splitK")),
    ("optimizer (AdamW)", ("multi_tensor_apply", "foreach", "adam")),
    ("softmax (decode attention, cross entropy)", ("softmax", "nll_loss")),
    ("reduce (rmsnorm mean, max)", ("reduce",)),
    ("copy/cast (KV-cache writes, casts, GQA repeat, cat, embedding)",
     ("copy", "Cat", "index", "gather", "scatter", "fill")),
    ("elementwise (rmsnorm, rope, silu, residual)",
     ("elementwise", "vectorized", "unrolled")),
]


def group_of(name):
    name = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in name for k in keys):
            return group
    return "other"


def device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def untraced_ms(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def range_ms(evt, attr_names):
    for attr in attr_names:
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value) / 1e3
    return 0.0


def profile(fn, steps, ranges=()):
    """Trace ``steps`` synchronised calls of ``fn`` after two warm-up
    calls; device time by group, launches, busy and idle share; for each
    ``record_function`` range named in ``ranges``, the host and device
    time inside it per call."""
    for _ in range(2):
        fn()
    wall_untraced = untraced_ms(fn, steps)
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.PARTIAL_LAUNCHES = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, launches, in_ranges = {}, 0, {}
    for evt in prof.key_averages():
        if evt.key in ranges:
            # a range has a host entry and a device entry (its span on the
            # card's timeline), neither of them a kernel
            entry = in_ranges.setdefault(evt.key, {"host_ms": 0.0,
                                                   "device_ms": 0.0})
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                entry["device_ms"] += range_ms(
                    evt, ("device_time_total", "cuda_time_total")) / steps
            else:
                entry["host_ms"] += range_ms(evt, ("cpu_time_total",)) / steps
            continue
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            launches += evt.count
    if not kernels:
        raise SystemExit("torch.profiler saw no device time")
    by_group = {}
    for name, us in kernels.items():
        group = group_of(name)
        by_group[group] = by_group.get(group, 0.0) + us / steps / 1e3
    busy_ms = sum(kernels.values()) / steps / 1e3
    return {
        "steps": steps,
        "wall_ms_untraced": wall_untraced,
        "wall_ms_traced": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_untraced": max(0.0, 1 - busy_ms / wall_untraced),
        "host_gap_ms_untraced": max(0.0, wall_untraced - busy_ms),
        "kernel_launches_per_call": launches / steps,
        "flash_launches_per_call": fa.LAUNCHES / steps,
        "flash_partial_launches_per_call": fa.PARTIAL_LAUNCHES / steps,
        "flash_bwd_launches_per_call": [fa.BWD_DQ_LAUNCHES / steps,
                                        fa.BWD_DKV_LAUNCHES / steps],
        # the kernels each mm/addmm/bmm op launched, gemm or not
        "device_ms_by_matmul_op": matmuls_by_op(prof, steps),
        "device_ms_by_group": dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        "top_kernels_ms": {k[:90]: v / steps / 1e3 for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]},
        "ranges_ms_per_call": in_ranges,
    }


def matmuls_by_op(prof, steps):
    """{MATMUL_OPS group: device ms per call}: the kernels the trace links
    to each ``aten::mm``, ``addmm`` or ``bmm`` op, float32 or not by the
    kernel's name."""
    out = {}
    for evt in prof.events():
        for kernel in evt.kernels:
            f32 = any(k in kernel.name for k in F32_GEMM)
            group = MATMUL_OPS.get((evt.name, f32))
            if group is not None:
                out[group] = (out.get(group, 0.0)
                              + kernel.duration / steps / 1e3)
    return out


def profile_training(steps, zoo, params):
    """One training step of the flagship LM (``zoo`` entry, ``params``)
    through the port's trainer at bench_transformer.py's shape."""
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    if "remat=" not in params:
        params += ";remat=true"
    spec = load_model_spec(zoo, params)
    cfg = spec.config
    trainer = CollectiveTrainer(spec, batch_size=BATCH, device="cuda")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(BATCH, cfg.max_seq_len)).astype(
            np.int32)).cuda()
    result = profile(lambda: trainer.train_minibatch(tokens, tokens),
                     steps)
    result["call"] = ("%s training step batch %d x %d, bf16 compute, AdamW; "
                      "%s" % (zoo, BATCH, cfg.max_seq_len, params))
    return result


def _ranged(module, name, label):
    """Wrap ``module.name`` in a ``record_function`` range ``label``,
    entered after a synchronise."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    return label


def sp_rank_profile(steps, params, sp):
    """One rank of ``profile_sp_training``."""
    from elasticdl_tpu_torch.parallel import transport
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import SPMDTrainer

    build.build_all()
    mesh = build_mesh(sp=sp, backend="gloo")
    if "remat=" not in params:
        params += ";remat=true"
    spec = load_model_spec("transformer", params)
    cfg = spec.config

    def loss_fn(module, batch):
        toks, targets = batch
        logits = tfm.forward(module, toks, cfg, mesh=mesh)
        return tfm.next_token_loss_sum(logits, targets), (targets >= 0).sum()

    trainer = SPMDTrainer(mesh, spec.init_fn, loss_fn, spec.optimizer,
                          param_specs=tfm.param_specs(cfg))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(BATCH, cfg.max_seq_len)))
    batch = (tokens, tfm.next_token_targets(tokens))
    ranges = (_ranged(fa, "_partial_stats_bwd", "partial backward"),
              _ranged(transport, "shift", "transport: ring shifts"),
              _ranged(transport, "all_reduce_sum_",
                      "transport: all-reduces"))
    torch.cuda.reset_peak_memory_stats()
    result = profile(lambda: float(trainer.train_step(batch)), steps,
                     ranges)
    result["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result["call"] = ("SPMDTrainer step at sp=%d, rank %d of the card %s, "
                      "batch %d x %d (%d positions a rank), bf16 compute, "
                      "AdamW; %s" % (sp, mesh.coords["sp"], mesh.device,
                                     BATCH, cfg.max_seq_len,
                                     cfg.max_seq_len // sp, params))
    return result


def profile_sp_training(steps, params, sp):
    """``sp`` ranks on the card, each profiling an SPMDTrainer step."""
    from elasticdl_tpu_torch.parallel import launch

    return launch.spawn(sp_rank_profile, sp, (steps, params, sp),
                        timeout=1500)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--train", action="store_true",
                        help="profile a training step instead of serving")
    parser.add_argument("--model_params", default="",
                        help="zoo settings added to the flagship's")
    parser.add_argument("--sp", type=int, default=1,
                        help="with --train: ranks of a sequence-parallel "
                             "mesh sharing the card (ring attention)")
    parser.add_argument("--zoo", default="transformer",
                        choices=("transformer", "lora"),
                        help="lora: LoRA adapters on a frozen base "
                             "(with --train)")
    args = parser.parse_args()
    params = ";".join(p for p in (LM_PARAMS, args.model_params) if p)
    if args.zoo == "lora":
        if not args.train:
            raise SystemExit("--zoo lora profiles training (--train): its "
                             "servable is a merged plain transformer")
        params += ";" + LORA_PARAMS
    if args.sp > 1 and (not args.train or args.zoo != "transformer"):
        raise SystemExit("--sp profiles the transformer's training step "
                         "(--train)")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    build.build_all()
    if args.train and args.sp > 1:
        for result in profile_sp_training(args.steps, params, args.sp):
            print(json.dumps(result))
        return
    if args.train:
        print(json.dumps(profile_training(args.steps, args.zoo, params)))
        return
    spec = load_model_spec("transformer", params)
    cfg = spec.config
    module = spec.init_fn("cuda", seed=0)
    rng = np.random.RandomState(0)
    results = []
    with torch.inference_mode():
        w = tfm._cast(module, cfg)       # once per request, as generate
        for T, max_len in ((PROMPT, PROMPT + NEW), (cfg.max_seq_len,
                                                   cfg.max_seq_len)):
            x = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, size=(BATCH, T))).cuda()
            result = profile(lambda: tfm._prefill(w, cfg, x, max_len),
                             args.steps)
            result["call"] = "prefill batch %d, T=%d, bf16; %s" % (
                BATCH, T, params)
            results.append(result)
        prompt = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, size=(BATCH, PROMPT))).cuda()
        _, caches = tfm._prefill(w, cfg, prompt, PROMPT + NEW)
        tok = prompt[:, -1]
        result = profile(
            lambda: tfm._decode_step(w, cfg, caches, PROMPT, tok),
            args.steps)
        result["call"] = ("decode step batch %d at position %d, bf16; %s"
                          % (BATCH, PROMPT, params))
        results.append(result)
    for result in results:
        print(json.dumps(result))


if __name__ == "__main__":
    main()
