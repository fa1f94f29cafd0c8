#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA card
and check it end to end.  Run from the root of a checkout:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: every kernel in elasticdl_tpu_torch/ops/csrc/, with nvcc, one
    process per source, all started together;
 3. forward kernel against plain: the GroupNorm forward (B1) against its
    plain PyTorch version at every GroupNorm shape of ResNet-50, at the
    served batch (4) and at batch 32 in float32 and bfloat16 and at
    bench.py's batch (128) in bfloat16, ReLU off and on, plus a
    large-mean case; then, per shape at batch 32 in both dtypes and at
    batch 128 in bfloat16, the kernel's time, the plain version's,
    F.group_norm's (a yardstick the port never calls) and the bound,
    summed over the 53 calls of a forward with the share of the bound
    reached;
 4. backward kernel against plain: the GroupNorm backward (B2) against
    its plain version (``_bwd_ref``) at every shape, at batch 32 in
    float32 and bfloat16 and at batch 128 in bfloat16, ReLU as the model
    uses it; two runs must be bitwise equal; then per shape at batch 32
    in both dtypes and at batch 128 in bfloat16 the kernel's time, the
    plain version's, the backward alone of F.group_norm + ReLU through
    autograd, and the bound, summed over the 53 calls of a step;
 5. serving: TF32 off, as the serving entry point turns it off; a seeded
    ResNet-50 (224x224x3 in, 1000 classes) is exported with the port's
    exporter, served by the port's HTTP server on the card, and answers
    three :predict requests of four images;
    predictions must match the same module run with the plain GroupNorm,
    and the forward kernel must have launched 53 times per forward;
 6. forward: the served module's forward at batch 4 and 32 with the
    kernel and with the plain GroupNorm, in turns;
 7. training: ResNet-50 at full size trained through the port's
    CollectiveTrainer from seeded random weights, batch 32, float32 with
    TF32 off: 3 steps with the kernels and 3 with the plain GroupNorm
    (losses and step-1 gradients compared; every parameter must get a
    gradient; 53 forward + 53 backward launches per step); 10 steps on
    one batch (the loss must fall); a checkpoint restored into a fresh
    trainer must hold the same parameters and SGD momentum and give the
    same next loss; then bench.py's setting, batch 128 with bf16
    compute: in two warm-up steps every GroupNorm call, forward and
    backward, is held against its plain version on the activations and
    gradients the path gives it; then ms per step and images/s;
 8. flash attention kernel against plain: the flash attention forward
    (B3) against its plain version (``_flash_ref``: out, l and m) at the
    served transformer's prefill shapes (q, k, v [8, 16, 128, 64] and
    [8, 16, 2048, 64]), non-causal, a sliding window, head_dim 128, a
    ragged T and the edges of the bf16 kernel's 128-row blocks (T = 1,
    127, 129, windows of 64 and 128 keys), in float32 and bfloat16
    (FLASH_CHECKS); two runs at [8, 16, 2048, 64] bf16 must be bitwise
    equal; then, at [8, 16, 2048, 64] causal in both dtypes and at
    [8, 8, 2048, 128] bf16 (head_dim 128 at the same FLOPs), the
    kernel's time, the plain version's, F.scaled_dot_product_attention's
    (a yardstick the port never calls), the bound and the share of it
    reached;
 9. transformer serving: the flagship LM (vocab 32768, dim 1024, 24
    layers, 16 heads, 436 M parameters, seeded random weights, bf16
    compute) exported with the port's ``export_generate`` (greedy,
    prompt 128, 128 new tokens), served by the port's HTTP server on the
    card and queried with three :predict requests of 8 prompts; the
    kernel must launch 24 times per request (once per layer of prefill)
    and each prompt must come back unchanged; then, on the same module
    with plain attention: teacher forcing over the generated sequences,
    prefill logits in bf16, and in float32 with TF32 off at T=2048,
    batch 2; then prefill time at batch 8, T=128 and T=2048, with the
    kernel and with plain attention;
10. flash attention backward kernels against plain: dq (B4) and dk, dv
    (B5) against their plain version (``_flash_bwd_ref``) on the forward
    kernel's residuals and a random g, at the flagship training shape
    ([8, 16, 2048, 64] causal) in float32 and bfloat16, non-causal, a
    sliding window, head_dim 128, a ragged T and the edges of the bf16
    kernels' 128-row blocks (T = 1, 127, 129, a 64-key window;
    FLASH_BWD_CHECKS), held row by row and by norm, two runs bitwise
    equal; then, at the flagship shape in both dtypes and at [8, 8, 2048,
    128] bf16, each kernel's time and bound, the whole plain backward's
    time and the backward alone of F.scaled_dot_product_attention (a
    yardstick the port never calls), and for B4, B5 and the pair the
    share of the bound reached and the ratio to that backward;
11. transformer training: the flagship LM (436 M parameters, seeded
    random weights) trained through the port's CollectiveTrainer at
    bench_transformer.py's shape, batch 8 x 2048, bf16 compute, AdamW,
    remat=True, dense cross entropy.  First, in float32 with TF32 off at
    batch 2: step-1 gradients with the kernels against the plain
    Function (``flash_attention_ref``), and remat=False and
    xent_chunk=512 against remat=True; the same kernels-vs-plain check at
    the main path's settings (bf16 compute, batch 8), to whose limits
    remat=False, "dots" and "attn" are then held against remat=True
    (launches B3 24, 48, 48; B4, B5 24).  Then one step
    whose launches are counted (B3 48 times, forward and remat
    recompute; B4 and B5 24 times each) and after which every parameter
    must hold a finite gradient; LM_TRAIN_STEPS timed steps on the same batch (the loss
    must fall), ms per step, tokens/s and the model-FLOP share (mfu);
    LM_PLAIN_STEPS with the plain Function; a checkpoint (parameters and
    AdamW moments in the JAX names and layouts) restored into a fresh
    trainer bit for bit, with the same next loss;
12. MoE serving: Flagship-MoE (the flagship widths with 8 experts, top-2
    gating, capacity factor 2, aux weight 0.01; 2,550 M parameters,
    seeded random weights, bf16 compute) exported with
    ``export_generate`` in float32 (the temporary directory's free space
    printed first; a shortfall fails), served over HTTP (MOE_REQUESTS
    requests of 8 prompts, 128 + 128 tokens, 24 B3 launches each); the
    first request's 24 prefill attention calls held against the plain
    version on their own q, k, v (FLASH_TOL) and its served tokens
    against in-process ``generate``; the tokens teacher-forced through
    plain attention by prefill and decode steps (an MoE forward over the
    whole sequence drops tokens past an expert's capacity, a decode step
    never does), the share past LM_TF_TOL held against plain-vs-plain
    (MOE_TF_SHARE), and the prefill logits held against plain attention's
    as the dense LM's;
13. MoE training at batch 8 x 2048, bf16 compute, AdamW, remat: step-1
    gradients with the kernels against the plain Function, leaf by leaf
    against their floors (router and expert leaves nonzero); one counted
    step (B3 48, B4 24, B5 24) and MOE_TRAIN_STEPS timed steps through
    the CollectiveTrainer (the loss must fall), the aux loss before and
    after, ms per step, tokens/s and peak memory;
14. remat policies: the dense LM through the trainer at batch 8 x 2048
    under remat False, True, "dots" and "attn": launches per step, ms
    per step over REMAT_STEPS steps, peak allocated memory;
15. LoRA (rank 8, alpha 16, the attention projections) on the dense LM
    exported by phase 9, through the trainer at batch 8 x 2048, bf16,
    remat: step-0 logits bitwise the base's; one counted step and
    LORA_STEPS timed steps (the loss must fall), then the base bitwise
    unchanged and optimizer state for the adapters only; the merged
    weights' forward against the LoRA forward (LM_TOL); the merged
    weights exported with ``export_generate`` and served over HTTP give
    the tokens in-process ``generate`` gives;
16. sequence parallelism: the unnormalised flash forward (B3p, ring
    attention's block step) against its plain version (``_partial_ref``:
    acc, l and m) at the sp=2 ring's blocks ([8, 16, 1024, 64], causal
    and not, both dtypes), head_dim 128, windows of 64 and 128 keys and
    T = 1, 127, 129, 257 (PARTIAL_CHECKS), bitwise across two runs, and
    timed against its bound and ``_partial_ref``; then ranks spawned on
    the card (``parallel/launch.py``: one process each, gloo groups whose
    transport stages tensors through the host, joins under a time limit):
    at sp=2, ring attention at the flagship's attention shape in bf16
    (and f32 at batch 2) against attention_local on one rank and the dense
    f32 softmax; the flagship LM (24 layers, full width, batch 8 x 2048,
    bf16, AdamW, remat) through the port's SPMDTrainer: step-1 loss and
    gradients against the sp=1 path (f32 at batch 2, bf16 at batch 8),
    one counted step (B3p 48 launches on rank 0, 96 on rank 1; B3, B4 and
    B5 none), SP_TIMED_STEPS timed steps (the loss must fall; ms per step,
    tokens/s and peak memory per rank) and a checkpoint saved at sp=2,
    restored at sp=1 in this process (the same loss before and after one
    more step); at sp=4 (ring distances 2 and 3), ring attention causal
    and with a window that bands two blocks and skips the third, and a
    4-layer full-width LM's step-1 gradients (rank r launches B3p 8 (r +
    1) times);
17. the master/worker process path: in this process, the flagship LM at
    full width and depth (remat) trained through the port's master
    (TaskManager and gRPC servicer) and Worker task loop, two jobs of 4
    tasks of 4 minibatches at batch 8 x 2048, each step launching B3 48
    times and B4, B5 24 times, every parameter on the card, the loss
    falling in each job; ms per step and tokens/s beside the direct
    CollectiveTrainer step timed before, between and after the jobs on
    the same trainer; then the master CLI
    (``python -m elasticdl_tpu_torch.master.main``) with two worker
    processes on the card (no device variable: the workers' default),
    the flagship's widths at 4 layers from an empty kernel cache, worker
    0 killed -9 after its first checkpoint: its task requeued, a
    replacement launched that restores the checkpoint and trains, the
    job finishing with exit 0 and no failed task; start-up, checkpoint
    and recovery seconds;
18. the managed elastic-collective path: ResNet-50 at full size (224x224,
    1000 classes, float32, TF32 off) trained by two ranks spawned on the
    card, each at batch 32 over a data mesh whose world is formed through
    the port's MasterCoordinationService and initialize_from_rendezvous
    on gloo (host-staged transfers: both ranks share the card); step-1
    loss and gradients against a single-process step at batch 64 (each
    leaf within COLL_FLOOR_X x its floor, the largest distance from the
    dense f32 plain path of the kernels at batch 64 and at 32 and of the
    plain path at 32; COLL_GRAD_MIN at least), B1/B2 53 launches a step a
    rank, ms a step and the all-reduce's ms a step; then the world
    re-formed 2 -> 1 -> 2 in place: parameters and momentum kept bit for
    bit, a joiner with other weights adopting rank 0's bit for bit and
    taking the same next step; then the master CLI with
    ``--distribution_strategy collective`` and two workers on the card
    (resnet50_cifar10, synthetic_cifar10, kernels from the build phase's
    directory), worker 0 killed -9 once both have stepped in a world of
    2: the survivor's in-band failure, an epoch of world 1, the relaunch,
    an epoch of world 2 again, B1/B2 53 launches a pass in every worker
    that exits, the job finishing with exit 0 and no failed task;
    recovery seconds and steps/s at worlds 2 and 1;
19. ZeRO-1 on the collective path: ResNet-50 at full size trained by two
    ranks on the card as in phase 18, ZERO_STEPS steps with zero1=True
    and the same steps with zero1=False over a second mesh of the same
    world, both on cuDNN's deterministic algorithms (two zero1=False legs
    on its defaults first show whether those reproduce): losses,
    parameters and the whole optimizer state (the shards gathered) bit
    for bit equal, B1/B2 53 launches a step a rank, the
    optimizer state a rank half the replicated, ms a step both ways and
    the parameter all-gather's ms; then 2 -> 3 with a joiner (the state
    bit for bit that of before, the no-churn reference) and 3 -> 2 with a
    leaver (the moments restarted, the parameters kept); then phase 18's
    CLI job with ``--zero1 true`` and a kill -9: the ZeRO-1 placement
    logged at a world of 2, the survivor's moment restart at the shrink,
    exit 0 with no failed task;
20. the collective LM: the flagship LM at full width and depth (bf16,
    AdamW, remat) trained by two ranks spawned on the card at batch 4
    each, the world formed as phase 18's: step-1 loss and gradients in
    float32 at batch 1 a rank and in bf16 at 4 a rank against phase 11's
    single process at the global batch (each leaf within its limit of
    the dense f32 softmax path's), B3/B4/B5 48/24/24 launches a step a
    rank, ms a step, the all-reduce's ms, tokens/s and peak memory a
    rank; the world re-formed 2 -> 1 -> 2 in place (parameters and AdamW
    moments kept bit for bit, a joiner with other weights adopting rank
    0's); then zero1=False and zero1=True, CLM_ZERO_STEPS steps each
    (the zero1=False leg reproduces the bf16 leg's steps, and ZeRO-1
    equals both bit for bit: losses, parameters, the whole AdamW state),
    the AdamW state a rank, ms a step both ways and the parameter
    all-gather's ms; then the port's wrap-your-own-loop example
    (``models/mnist_torch.py``: an ElasticDataset, 16 batches of 32, a
    port master in this process) on the card;
21. MobileNetV2 and the job types: MobileNetV2 (2,236,682 parameters,
    the CIFAR-10 stem, flax's GroupNorm in plain torch ops) through the
    port's CollectiveTrainer at batch 128, float32 with TF32 off and
    bf16, 10 steps each on one batch (the loss must fall): step-1 loss
    and every gradient leaf against the port's CPU run from the same
    weights and batch (each leaf by its distance from the CPU's float64
    run, within a multiple of the CPU's own run at that dtype), ms a
    step, images/s, peak memory; then, in this process, a
    resnet50_cifar10 checkpoint written by one step, and three
    ``--job_type predict`` jobs over 1,024 synthetic CIFAR records (4
    tasks of 2 x 128) built by the master and worker entry points
    (``build_master``, ``start_status_server`` on ``--status_port 0``,
    ``build_worker``), the second one's run under ``device_trace`` and
    the others' not (the profiler's cost, on the same job): every
    record's row once, within JOB_ROW_TOL of the in-process forward of
    the restored checkpoint, B1 53 launches a forward, /healthz, /status
    and /metrics (the same task counts) mid-job, /profilez refused
    while the device trace runs and capturing after it, the trace
    holding CUDA kernel events, B1's among them; then a ``--job_type
    evaluate`` job over the same records whose accuracy equals the
    in-process metric; rows/s, the trace's size and export seconds;
    the phase fails past PHASE21_BUDGET_S;
22. one JSON line of kernels, then the card's name and power limit, then
    {"ok": true, "device": {...}} as the last line.

Tolerances (|got - ref| <= atol + rtol * |ref|):
 - forward kernel vs plain, float32: 2e-5 / 2e-5, the JAX package's own
   forward tolerance (the two reduce in f32 in different orders);
 - forward, bfloat16: 3e-2 / 3e-2 (both round the same f32 value to
   bf16; a value near a rounding boundary may land one bf16 ulp, 2^-7
   relative at most, apart);
 - mean and rstd, both dtypes: 2e-5 / 2e-5 (f32 statistics);
 - large mean (1e4 + N(0, 1)), float32, against float64: 1e-2 / 1e-2,
   as the JAX package's stability test;
 - backward dx, float32: 3e-5 / 3e-4, the JAX package's gradient
   tolerance; bfloat16: 3e-2 / 3e-2 (one bf16 rounding of dx);
   dscale and dbias (f32 sums over B x HW terms in either dtype):
   1e-4 x their largest entry, absolute;
 - served logits vs the plain-GroupNorm module: 1e-3 * max|logit|
   absolute.  Convs run in float32 with TF32 off on both sides; the GN
   outputs differ by f32 rounding, carried through 53 layers;
 - training, kernels vs plain GroupNorm: losses at rtol TRAIN_LOSS_RTOL;
   each step-1 gradient leaf against the plain path and against a
   float64 reference; see TRAIN_GRAD_RTOL for why;
 - bench setting, each GroupNorm call against its plain version on the
   path's own tensors: the tolerances above, with every absolute one
   scaled by the size of what it bounds (y, dx, dscale and dbias by
   their largest plain entry, the mean by the largest |x|), since
   activations and gradients of a real step are not of unit size;
 - flash attention, the served and the trained transformer: FLASH_TOL,
   LM_TOL, LM_TF_TOL, FLASH_BWD_TOL and LM_GRAD_MIN below, each with its
   reason;
 - sequence parallelism: PARTIAL_TOL, SP2_ATTENTION's comment,
   ``sp1_reference`` and SP_LOSS_RTOL below;
 - the collective path: COLL_FLOOR_X, COLL_GRAD_MIN and COLL_LOSS_RTOL
   below; the collective LM: ``sp1_reference``'s limits and
   CLM_LOSS_RTOL below;
 - MobileNetV2 and the jobs: MB_LOSS_RTOL, MB_FLOOR_X, MB_GRAD_MIN and
   JOB_ROW_TOL below.
"""

import argparse
import contextlib
import http.client
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

DEVICE = "cuda"                # where the new phases' tensors live
BATCH = 32                     # the kernel table's batch
SERVE_BATCH = 4                # images per :predict request
REQUESTS = 3
GROUPS = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside tensor cores
SPIN_CYCLES = 2_000_000        # about 1 ms at the H100's clock
FLOPS_PER_ELEMENT = 7          # stats: sub, add, fma; normalize: fma, max;
                               # the two converts of bf16
BWD_FLOPS_PER_ELEMENT = 15     # mask: fma, compare; s1: add; s2: sub, mul,
                               # fma; dx: sub, mul, mul, sub, mul, sub,
                               # mul; the three converts of bf16
# ResNet-50 at 224x224: (HW, C, ReLU as the model uses it, calls per
# forward).  1 stem + 3 in each of 16 bottlenecks + 4 shortcuts = 53.
RESNET50_GN = [
    (112 * 112, 64, True, 1),
    (56 * 56, 64, True, 6),
    (56 * 56, 128, True, 1),
    (56 * 56, 256, False, 4),
    (28 * 28, 128, True, 7),
    (28 * 28, 256, True, 1),
    (28 * 28, 512, False, 5),
    (14 * 14, 256, True, 11),
    (14 * 14, 512, True, 1),
    (14 * 14, 1024, False, 7),
    (7 * 7, 512, True, 5),
    (7 * 7, 2048, False, 4),
]
GN_PER_FORWARD = 53
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
BWD_TOL = {"float32": (3e-5, 3e-4), "bfloat16": (3e-2, 3e-2)}
TRAIN_LR = 1e-3              # seeded random weights: 1e-2 is chaotic
TRAIN_STEPS = 3                # kernels vs plain GroupNorm
FALL_STEPS = 10                # one batch, repeated
BENCH_BATCH = 128              # bench.py's resnet50_train_throughput
BENCH_STEPS = 10
# (batch, dtypes) of the kernel checks against plain: the served batch,
# bench.py's training batch in bfloat16, and the kernel table's batch
# (last: its tensors are the ones timed).
CHECK_BATCHES = ((SERVE_BATCH, ("float32", "bfloat16")),
                 (BENCH_BATCH, ("bfloat16",)),
                 (BATCH, ("float32", "bfloat16")))
# Kernels vs plain GroupNorm in training, float32 with TF32 off on both
# sides.  The two GroupNorms round differently (sums in other orders),
# by about 1e-6 relative per call; 53 layers forward and back carry that
# into the loss and the gradients.  Losses agree to about 1e-6.  The
# step-1 gradients of seeded random weights are far more sensitive: the
# phase also computes them in float64 (model, GroupNorm and loss), and
# the plain float32 path alone lies up to about 8e-3 (norm-relative,
# ||g - g64|| / ||g64||) from them on the early GroupNorm and conv
# leaves, the kernel path as far; two float32 paths with independent
# rounding then differ by up to about 1e-2.  A leaf fails at 2e-2 against
# the plain path, or at 3x the plain path's own distance from float64
# (plus 1e-4) against float64: a kernel off by more than rounding (a
# dropped ReLU mask, a wrong group mean) moves a leaf by O(1).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 2e-2
# Flash attention forward (B3) against its plain version ``_flash_ref``:
# (B, H, T, D, dtype, causal, window).  The served model's prefill at the
# decode bench's prompt (T=128) and at its longest (T=2048, both
# dtypes), non-causal, a sliding window, head_dim 128 and a ragged T;
# then the edges of the bf16 D=64 kernel's blocks (256 rows; 128 in the
# sweep's two-warpgroup variants) and 64-row tiles: one position, T = 127,
# 129, 255 and 257, and windows of one and two tiles.
FLASH_CHECKS = [
    (8, 16, 128, 64, "bfloat16", True, 0),
    (8, 16, 2048, 64, "bfloat16", True, 0),
    (8, 16, 2048, 64, "float32", True, 0),
    (2, 16, 2048, 64, "bfloat16", False, 0),
    (2, 16, 2048, 64, "float32", False, 0),
    (2, 16, 2048, 64, "bfloat16", True, 256),
    (4, 8, 2048, 128, "bfloat16", True, 0),
    (2, 16, 1000, 64, "bfloat16", True, 0),
    (2, 16, 1000, 64, "float32", False, 0),
    (2, 16, 1, 64, "bfloat16", True, 0),
    (2, 16, 1, 64, "bfloat16", False, 0),
    (2, 16, 127, 64, "bfloat16", True, 0),
    (2, 16, 127, 64, "bfloat16", False, 0),
    (2, 16, 129, 64, "bfloat16", True, 0),
    (2, 16, 129, 64, "bfloat16", False, 0),
    (2, 16, 255, 64, "bfloat16", True, 0),
    (2, 16, 257, 64, "bfloat16", False, 0),
    (2, 16, 2048, 64, "bfloat16", True, 64),
    (2, 16, 2048, 64, "bfloat16", True, 128),
]
FLASH_TIMED = (8, 16, 2048, 64)  # the flagship long prefill, causal
# head_dim 128 at the flagship's FLOPs (half the heads), bf16, causal
FLASH_TIMED_D128 = (8, 8, 2048, 128)
# out: float32 2e-5 / 2e-5, the JAX oracle's tolerance (sums in other
# orders); bfloat16 2e-2 / 2e-2: the kernel rounds p = exp(s - m) to bf16
# against its running row max, the plain version against the final one,
# so the two sit up to one bf16 rounding of p and one of out apart.  m
# within 1e-5 x max|s|; l within 2e-5 relative.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
BF16_FLOPS_PER_S = 989e12      # H100 SXM tensor cores, dense bf16
# The flagship transformer LM (bench_transformer.py's ~400M config),
# served greedy at the decode bench's shape: 8 prompts of 128 tokens per
# :predict, 128 new tokens each.
LM_PARAMS = ("vocab_size=32768;dim=1024;num_heads=16;num_layers=24;"
             "seq_len=2048;dtype=bfloat16")
LM_BATCH, LM_PROMPT, LM_NEW = 8, 128, 128
# Prefill logits, kernel path vs plain attention, as a share of the
# largest |logit|: bf16 compute 2e-2 (every layer's activations round to
# bf16; the two attention outputs sit a bf16 rounding of p apart and 24
# layers of seeded random weights amplify it); float32 with TF32 off
# 1e-3 (sums in other orders through 24 layers).  The bf16 limit is
# raised to LM_FLOOR_X times the run's own noise floor where that is
# larger: the distance between two equally valid plain paths, p rounded
# to bf16 and p kept in f32, on the same prompts (measured 0.0191 of
# max|logit| on the H100, against 0.0197 for the kernel).  A kernel that
# is wrong (a mask, a scale, a lost tile) moves logits by O(1).
# Teacher forcing: the plain path's logit of each token the kernel path
# chose lies within 2 x 2e-2 of the plain row max (each of the two
# logits may be off by the prefill tolerance).
LM_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
LM_FLOOR_X = 1.5
LM_TF_TOL = 4e-2
# Flash attention backward (B4 dq, B5 dk/dv) against its plain version
# ``_flash_bwd_ref`` on the forward kernel's residuals and a random g:
# (B, H, T, D, dtype, causal, window).  The flagship training shape in
# both dtypes, non-causal, a sliding window, head_dim 128 and a ragged T;
# then the edges of the bf16 D=64 kernels' 128-row blocks and 64-row
# tiles: one position, T = 127 and 129, and a window of one tile.
FLASH_BWD_CHECKS = [
    (8, 16, 2048, 64, "bfloat16", True, 0),
    (8, 16, 2048, 64, "float32", True, 0),
    (2, 16, 2048, 64, "bfloat16", False, 0),
    (2, 16, 2048, 64, "float32", False, 0),
    (2, 16, 2048, 64, "bfloat16", True, 256),
    (2, 16, 2048, 64, "float32", True, 256),
    (4, 8, 2048, 128, "bfloat16", True, 0),
    (4, 8, 2048, 128, "float32", True, 0),
    (2, 16, 1000, 64, "bfloat16", True, 0),
    (2, 16, 1000, 64, "float32", False, 0),
    (2, 16, 1, 64, "bfloat16", True, 0),
    (2, 16, 127, 64, "bfloat16", True, 0),
    (2, 16, 129, 64, "bfloat16", False, 0),
    (2, 16, 2048, 64, "bfloat16", True, 64),
]
# dq, dk, dv are held row by row (``bwd_errors``): each row's error
# ||got_r - ref_r|| over the larger of ||ref_r|| and the median row norm
# (rows that sum few terms are not held to their own tiny norms), and the
# whole tensor's ||got - ref|| / ||ref||; FLASH_BWD_TOL gives (row limit,
# norm limit).  float32: sums in other orders, p from exp2 in the kernel.
# bfloat16: both versions round ds, p and the outputs to bf16 from f32
# values that differ in their last bits, so an element lands one bf16 ulp
# apart now and then.  Each limit is about 3x the largest reading over
# FLASH_BWD_CHECKS on the H100 (row 1.3e-5 and 5.9e-3, norm 1.9e-7 and
# 1.8e-4; PERF.md).  ``gate_self_test`` shows at the flagship shape that
# the gate rejects a kernel that drops one 64-key tile from the last 64
# rows of dq, or zeroes dk past T/2.  Where a gradient is 0 in exact
# arithmetic (dq and dk at T = 1: p = 1 and out = v, so dp = delta) both
# versions are rounding noise and neither error can be read: there the
# kernel's ||got|| must stay under BWD_NOISE x ||g||, as in the `cuda`
# tests.
FLASH_BWD_TOL = {"float32": (4e-5, 6e-7), "bfloat16": (2e-2, 6e-4)}
BWD_NOISE = 1e-3
# Transformer training: bench_transformer.py's shape (batch 8 x 2048, bf16
# compute, AdamW, remat=True as that bench defaults, dense cross entropy),
# LM_TRAIN_STEPS timed steps on one batch (the loss must fall) and
# LM_PLAIN_STEPS with the plain attention Function.
LM_TRAIN_BATCH = 8
LM_TRAIN_STEPS = 10
LM_PLAIN_STEPS = 3
# Step-1 gradients in float32 (TF32 off) at batch 2, kernels against the
# plain Function: each leaf within LM_FLOOR_X times the run's own floor
# for that leaf, norm-relative (||g - g_plain|| / ||g_plain||), and never
# under LM_GRAD_MIN.  The floor is the distance between two equally valid
# plain paths, the plain Function and autograd through the dense f32
# softmax ``_attention_ref`` (up to 6.25e-6 on the H100, with the kernels
# 5.85e-6 from the plain Function; PERF.md).  remat=False and
# xent_chunk=512 against remat=True (kernels in all three) are held to the
# same limits, and their losses within LM_GRAD_MIN relative.  Then the
# same at the main path's settings (bf16 compute, remat, batch
# LM_TRAIN_BATCH x 2048: the bf16 kernels on the strided ring-layout views
# of a training step), each leaf within LM_FLOOR_X times its bf16 floor.
LM_GRAD_BATCH = 2
LM_GRAD_MIN = 1e-5
# Flagship-MoE: the flagship widths with the zoo's MoE settings, top-2
# gating over 8 experts (GShard, as Mixtral 8x7B), the JAX defaults of
# capacity factor 2.0 and aux weight 0.01; 2,550 M parameters.  Served as
# the dense LM (MOE_REQUESTS requests), trained at the dense LM's
# training shape.
MOE_PARAMS = LM_PARAMS + ";moe_experts=8;moe_top_k=2"
MOE_REQUESTS = 2
# MoE teacher forcing.  A routing choice that bf16 rounding flips moves a
# token's logits by up to ~0.3 x max|logit|, between two plain paths as
# between the kernel and plain (prefill floors ~0.35, PERF.md), so no
# per-token limit separates them; the share of chosen tokens past
# LM_TF_TOL is held instead: to MOE_TF_SHARE or LM_FLOOR_X x the plain-
# vs-plain share (8.9 % against the kernel's 5.2 % on the H100),
# whichever is larger.  A wrong kernel moves nearly every token.  The
# kernel itself is held per call on the path's own q, k, v (FLASH_TOL).
MOE_TF_SHARE = 0.01
MOE_TRAIN_STEPS = 5
# Timed steps per remat setting (remat_phase).
REMAT_STEPS = 3
# LoRA on the dense flagship: rank 8, alpha 16, the attention projections
# (the JAX spec's defaults), remat, the JAX spec's learning rate 1e-4.
LORA_PARAMS = LM_PARAMS + ";remat=true;rank=8;alpha=16"
LORA_STEPS = 5


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr)
    sys.exit(1)


def check_close(what, got, ref, atol, rtol):
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    if not bool(got.isfinite().all()):
        fail("%s: non-finite output" % what)
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        fail("%s: %d elements off, max abs err %.3g (atol %g rtol %g)"
             % (what, int(bad.sum()), float(err.max()), atol, rtol))
    return float(err.max())


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps=15):
    """Median device time of one call, by CUDA events.  Before each call
    the L2 is flushed (a 256 MB write exceeds the 50 MB L2) and the card
    spins for about a millisecond, so the host has queued the whole call
    before the start event fires and its Python overhead stays out of
    the time."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(B, HW, C, esize, backward=False):
    """The least time for one call, over the memory rate or the f32
    rate, whichever is larger.  Forward: x read, y written (x's dtype),
    scale and bias read, mean and rstd written (f32).  Backward: x and
    dy read, dx written, scale, bias, mean and rstd read, dscale and
    dbias written."""
    big = (3 if backward else 2) * B * HW * C * esize
    nbytes = big + 2 * C * 4 + 2 * B * C * 4 + (2 * C * 4 if backward
                                                   else 0)
    flops = BWD_FLOPS_PER_ELEMENT if backward else FLOPS_PER_ELEMENT
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops * B * HW * C / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# (batch, dtype) of the GroupNorm kernels' timed sums, and the key of
# each in the totals: the kernel table's batch in both dtypes, and
# bench.py's training setting (batch 128, bf16 compute).
GN_TIMED = ((BATCH, "float32", "float32"), (BATCH, "bfloat16", "bfloat16"),
            (BENCH_BATCH, "bfloat16", "bfloat16 b128"))


def add_row(rows, totals, key, row, count):
    rows.append(row)
    for part in totals[key]:
        totals[key][part] += count * row[part]


def new_totals():
    return {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
            for _, _, key in GN_TIMED}


def finish_totals(totals):
    for tot in totals.values():
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]


def gn_sums(tot):
    """One timed sum of a GroupNorm kernel, as the kernels line gives
    it."""
    return {key: tot[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "share_of_bound")}


def kernel_phase(torch, gn):
    """Kernel against plain at every ResNet-50 GroupNorm shape, at the
    batches of CHECK_BATCHES; times at the (batch, dtype) of GN_TIMED."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    totals = new_totals()
    for HW, C, model_relu, count in RESNET50_GN:
        inputs = {}
        for batch, names in CHECK_BATCHES:
            x = torch.randn(batch, HW, C, generator=gen, device=dev)
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            inputs[batch] = (x, scale, bias)
            for name in names:
                xd = x.to(getattr(torch, name))
                atol, rtol = TOL[name]
                for relu in (False, True):
                    got = gn.group_norm_fwd(xd, scale, bias, GROUPS,
                                            relu=relu)
                    torch.cuda.synchronize()
                    ref = gn._fwd_ref(xd, scale, bias, GROUPS, 1e-6, relu)
                    what = "group_norm B=%d HW=%d C=%d %s relu=%s" % (
                        batch, HW, C, name, relu)
                    err = check_close(what, got[0], ref[0], atol, rtol)
                    check_close(what + " mean", got[1], ref[1], 2e-5, 2e-5)
                    check_close(what + " rstd", got[2], ref[2], 2e-5, 2e-5)
                    max_err[name] = max(max_err[name], err)
                    print("check %-48s max_abs_err %.3g" % (what, err))
        for batch, name, key in GN_TIMED:
            x, scale, bias = inputs[batch]
            dtype = getattr(torch, name)
            xd = x.to(dtype)
            relu = model_relu

            def kernel():
                gn.group_norm_fwd(xd, scale, bias, GROUPS, relu=relu)

            def plain():
                gn._fwd_ref(xd, scale, bias, GROUPS, 1e-6, relu)

            def library():
                # F.group_norm takes channels second: the permuted view is
                # the same data; the call copies it to its own layout.
                y = F.group_norm(xd.permute(0, 2, 1), GROUPS,
                                 scale.to(dtype), bias.to(dtype), 1e-6)
                if relu:
                    torch.relu_(y)

            row = {"B": batch, "HW": HW, "C": C, "dtype": name,
                   "relu": relu, "per_forward": count,
                   "ms": time_ms(torch, kernel, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, library, flush)}
            row.update(bound(batch, HW, C, xd.element_size()))
            add_row(rows, totals, key, row, count)
            print("time B=%d HW=%d C=%d %s relu=%s x%d: kernel %.4f ms, "
                  "plain %.4f ms, F.group_norm %.4f ms, bound %.4f ms (%s)"
                  % (batch, HW, C, name, relu, count, row["ms"],
                     row["plain_ms"], row["library_ms"], row["bound_ms"],
                     row["bound_by"]))
        del inputs
    finish_totals(totals)

    # Large mean: 1e4 + N(0, 1), against float64.
    x = 1e4 + torch.randn(BATCH, 56 * 56, 256, generator=gen, device=dev)
    ones = torch.ones(256, device=dev)
    zeros = torch.zeros(256, device=dev)
    y = gn.group_norm_fwd(x, ones, zeros, GROUPS)[0]
    xr = x.double().reshape(BATCH, -1, GROUPS, 256 // GROUPS)
    m = xr.mean(dim=(1, 3), keepdim=True)
    v = ((xr - m) ** 2).mean(dim=(1, 3), keepdim=True)
    truth = ((xr - m) / torch.sqrt(v + 1e-6)).reshape(x.shape)
    err = check_close("group_norm large mean", y, truth, 1e-2, 1e-2)
    print("check %-48s max_abs_err %.3g" % ("large mean 1e4 std 1", err))
    return rows, max_err, totals


def check_bwd(torch, gn, args, name):
    """The backward kernel against ``_bwd_ref`` on ``args``, and two
    runs bitwise equal; returns dx's max abs error."""
    x = args[0]
    what = "group_norm_bwd B=%d HW=%d C=%d %s relu=%s" % (
        tuple(x.shape) + (name, args[-1]))
    got = gn.group_norm_bwd(*args)
    again = gn.group_norm_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            fail("%s: two runs are not bitwise equal" % what)
    ref = gn._bwd_ref(*args)
    atol, rtol = BWD_TOL[name]
    err = check_close(what + " dx", got[0], ref[0], atol, rtol)
    for part, g, r in (("dscale", got[1], ref[1]),
                       ("dbias", got[2], ref[2])):
        check_close("%s %s" % (what, part), g, r,
                    1e-4 * float(r.abs().max()), 0.0)
    print("check %-58s max_abs_err %.3g, bitwise-deterministic"
          % (what, err))
    return err


def backward_phase(torch, gn):
    """Backward kernel against plain at every ResNet-50 GroupNorm shape,
    ReLU as the model uses it, at the batches of CHECK_BATCHES but the
    served one; bitwise equal across two runs; times per shape at the
    (batch, dtype) of GN_TIMED."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    totals = new_totals()
    for HW, C, relu, count in RESNET50_GN:
        inputs = {}
        for batch, names in CHECK_BATCHES[1:]:
            x = torch.randn(batch, HW, C, generator=gen, device=dev)
            dy = torch.randn(batch, HW, C, generator=gen, device=dev)
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            inputs[batch] = (x, dy, scale, bias)
            for name in names:
                xd, dyd = x.to(getattr(torch, name)), dy.to(
                    getattr(torch, name))
                _, mean, rstd = gn.group_norm_fwd(xd, scale, bias, GROUPS,
                                                  relu=relu)
                args = (xd, dyd, scale, bias, mean, rstd, GROUPS, 1e-6,
                        relu)
                max_err[name] = max(max_err[name],
                                    check_bwd(torch, gn, args, name))
        for batch, name, key in GN_TIMED:
            x, dy, scale, bias = inputs[batch]
            dtype = getattr(torch, name)
            xd, dyd = x.to(dtype), dy.to(dtype)
            _, mean, rstd = gn.group_norm_fwd(xd, scale, bias, GROUPS,
                                              relu=relu)
            args = (xd, dyd, scale, bias, mean, rstd, GROUPS, 1e-6, relu)

            def kernel():
                gn.group_norm_bwd(*args)

            def plain():
                gn._bwd_ref(*args)

            # The backward alone of F.group_norm + ReLU on the permuted
            # input, through autograd (the graph is built once).
            xl = xd.permute(0, 2, 1).detach().requires_grad_()
            w = scale.to(dtype, copy=True).requires_grad_()
            b = bias.to(dtype, copy=True).requires_grad_()
            y = F.group_norm(xl, GROUPS, w, b, 1e-6)
            if relu:
                y = torch.relu(y)
            dyl = dyd.permute(0, 2, 1)

            def library():
                torch.autograd.grad(y, (xl, w, b), dyl, retain_graph=True)

            row = {"B": batch, "HW": HW, "C": C, "dtype": name,
                   "relu": relu, "per_step": count,
                   "ms": time_ms(torch, kernel, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, library, flush)}
            row.update(bound(batch, HW, C, xd.element_size(),
                             backward=True))
            add_row(rows, totals, key, row, count)
            print("time bwd B=%d HW=%d C=%d %s relu=%s x%d: kernel %.4f ms, "
                  "plain %.4f ms, F.group_norm backward %.4f ms, bound "
                  "%.4f ms (%s)" % (batch, HW, C, name, relu, count,
                                    row["ms"], row["plain_ms"],
                                    row["library_ms"], row["bound_ms"],
                                    row["bound_by"]))
            del y, xl, w, b
        del inputs
    finish_totals(totals)
    return rows, max_err, totals


@contextlib.contextmanager
def checked_group_norm(torch, gn, seen):
    """Hold every GroupNorm kernel call of the path against its plain
    version on the call's own tensors (the activations and incoming
    gradients the path hands the kernels, in the path's dtypes and
    layouts).  The Function looks both wrappers up at call time; the
    plain versions launch nothing, so the launch counts are untouched.
    ``seen`` gathers the calls, the worst errors (relative to the
    largest plain entry) and the smallest max |dy| of a backward call."""
    fwd, bwd = gn.group_norm_fwd, gn.group_norm_bwd

    def name_of(x3):
        return str(x3.dtype).replace("torch.", "")

    def amax(t):
        return float(t.abs().max())

    def checked_fwd(x3, scale, bias, num_groups, eps=1e-6, relu=False):
        got = fwd(x3, scale, bias, num_groups, eps, relu)
        ref = gn._fwd_ref(x3, scale, bias, num_groups, eps, relu)
        name = name_of(x3)
        what = "bench path group_norm_fwd %s %s relu=%s" % (
            tuple(x3.shape), name, relu)
        atol, rtol = TOL[name]
        scale_y = max(amax(ref[0]), 1e-30)
        err = check_close(what, got[0], ref[0], atol * scale_y, rtol)
        check_close(what + " mean", got[1], ref[1], 2e-5 * amax(x3), 2e-5)
        check_close(what + " rstd", got[2], ref[2], 2e-5, 2e-5)
        seen["fwd_calls"] += 1
        seen["fwd_rel_err"] = max(seen["fwd_rel_err"], err / scale_y)
        return got

    def checked_bwd(x3, dy3, scale, bias, mean, rstd, num_groups,
                    eps=1e-6, relu=False):
        args = (x3, dy3, scale, bias, mean, rstd, num_groups, eps, relu)
        got = bwd(*args)
        ref = gn._bwd_ref(*args)
        name = name_of(x3)
        what = "bench path group_norm_bwd %s %s relu=%s" % (
            tuple(x3.shape), name, relu)
        atol, rtol = BWD_TOL[name]
        scale_dx = max(amax(ref[0]), 1e-30)
        err = check_close(what + " dx", got[0], ref[0], atol * scale_dx,
                          rtol)
        for part, g, r in (("dscale", got[1], ref[1]),
                           ("dbias", got[2], ref[2])):
            check_close("%s %s" % (what, part), g, r, 1e-4 * amax(r), 0.0)
        seen["bwd_calls"] += 1
        seen["bwd_rel_err"] = max(seen["bwd_rel_err"], err / scale_dx)
        seen["min_max_dy"] = min(seen["min_max_dy"], amax(dy3))
        return got

    gn.group_norm_fwd, gn.group_norm_bwd = checked_fwd, checked_bwd
    try:
        yield
    finally:
        gn.group_norm_fwd, gn.group_norm_bwd = fwd, bwd


@contextlib.contextmanager
def plain_group_norm(resnet, gn):
    """Route the ResNet's GroupNorm layers to the plain PyTorch version."""
    kernel_gn = resnet.fused_group_norm
    resnet.fused_group_norm = (
        lambda x, s, b, g, eps=1e-6, relu=False:
        gn._group_norm_ref(x, s, b, g, eps, relu))
    try:
        yield
    finally:
        resnet.fused_group_norm = kernel_gn


def seeded_params(spec, module, seed):
    """Random weights in the JAX package's names and layouts."""
    rng = np.random.RandomState(seed)
    named = {}
    for name, value in spec.params_to_jax(module).items():
        shape = value.shape
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.randn(*shape) * math.sqrt(
                (2.0 if len(shape) == 4 else 1.0) / fan_in)
        elif name.endswith("scale"):
            arr = 1 + 0.1 * rng.randn(*shape)
        else:
            arr = 0.1 * rng.randn(*shape)
        named[name] = arr.astype(np.float32)
    return named


def http_json(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serving_phase(torch, gn):
    """Export, serve and query a seeded ResNet-50 through the port's
    entry points; returns the served module for the forward phase."""
    from elasticdl_tpu_torch.models import resnet
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.serving.export import export_servable
    from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()   # as the serving entry point: TF32 off
    model_params = "variant=resnet50;num_classes=1000;image_size=224"
    spec = load_model_spec("resnet", model_params)
    module = spec.init_fn("cuda")
    module.load_state_dict(spec.params_from_jax(
        seeded_params(spec, module, seed=0)))
    images = np.random.RandomState(1).rand(
        REQUESTS, SERVE_BATCH, 224, 224, 3).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = os.path.join(tmp, "resnet50", "1")
        export_servable(export_dir, "resnet", model_params, module,
                        images[0, :1], model_name="resnet50", version=1)
        del module
        endpoint = ModelEndpoint(os.path.dirname(export_dir),
                                 device="cuda")
        server = build_server(endpoint, port=0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            code, meta = http_json(port, "GET", "/v1/models/resnet50")
            if code != 200 or meta["metadata"]["version"] != 1:
                fail("metadata: %s %s" % (code, meta))
            if http_json(port, "GET", "/healthz") != (200,
                                                      {"status": "ok"}):
                fail("healthz")
            bodies = [json.dumps({"instances": batch.tolist()})
                      for batch in images]
            gn.LAUNCHES = 0
            latencies, predictions = [], []
            for body in bodies:
                t0 = time.perf_counter()
                code, out = http_json(port, "POST",
                                      "/v1/models/resnet50:predict", body)
                latencies.append((time.perf_counter() - t0) * 1e3)
                if code != 200:
                    fail("predict: %s %s" % (code, out))
                predictions.append(np.asarray(out["predictions"],
                                              np.float32))
            launches = gn.LAUNCHES
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if launches != GN_PER_FORWARD * len(bodies):
            fail("GroupNorm kernel launched %d times over %d forwards, "
                 "want %d each" % (launches, len(bodies), GN_PER_FORWARD))

        # Reference: the served module itself, with the plain GroupNorm.
        served = endpoint.model.module
        with plain_group_norm(resnet, gn), torch.inference_mode():
            refs = [served(torch.from_numpy(batch).cuda()).cpu().numpy()
                    for batch in images]
        if gn.LAUNCHES != launches:
            fail("the plain reference launched the kernel")
    max_err = 0.0
    for pred, ref in zip(predictions, refs):
        if pred.shape != (SERVE_BATCH, 1000) or not np.isfinite(pred).all():
            fail("predictions of shape %s, finite %s"
                 % (pred.shape, np.isfinite(pred).all()))
        err = float(np.abs(pred - ref).max())
        tol = 1e-3 * float(np.abs(ref).max())
        if err > tol:
            fail("served logits off the plain-GN module by %.3g > %.3g"
                 % (err, tol))
        max_err = max(max_err, err)
    print("serve: %d requests x %d images, latency ms %s, GroupNorm "
          "launches %d (%d per forward), logits max |x| %.3g, max abs err "
          "vs plain-GN module %.3g" % (
              len(bodies), SERVE_BATCH, ["%.1f" % t for t in latencies],
              launches, launches // len(bodies), float(np.abs(refs[0]).max()),
              max_err))
    return served, launches, latencies, max_err


def forward_phase(torch, gn, module, reps=10):
    """Host-clock time of one forward (input on the card, logits synced),
    kernel GroupNorm against plain, in turns kernel, plain, plain,
    kernel; the median of each."""
    from elasticdl_tpu_torch.models import resnet

    out = {}
    for batch in (SERVE_BATCH, BATCH):
        x = torch.from_numpy(np.random.RandomState(2).rand(
            batch, 224, 224, 3).astype(np.float32)).cuda()
        times = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            ctx = (plain_group_norm(resnet, gn) if which == "plain"
                   else contextlib.nullcontext())
            with ctx, torch.inference_mode():
                module(x)
                torch.cuda.synchronize()
                for _ in range(reps // 2):
                    t0 = time.perf_counter()
                    module(x)
                    torch.cuda.synchronize()
                    times[which].append((time.perf_counter() - t0) * 1e3)
        out[batch] = {k: float(np.median(v)) for k, v in times.items()}
        print("forward B=%d: kernel GN %.3f ms, plain GN %.3f ms" % (
            batch, out[batch]["kernel"], out[batch]["plain"]))
    return out


def float64_step1_grads(torch, spec, named, x, y):
    """Step-1 gradients of the mean loss with the whole model, its
    GroupNorm (plain, centered variance) and the loss in float64."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.models import resnet

    def group_norm64(x, scale, bias, groups, eps=1e-6, relu=False):
        B, C = x.shape[0], x.shape[-1]
        xr = x.reshape(B, -1, groups, C // groups)
        m = xr.mean(dim=(1, 3), keepdim=True)
        v = ((xr - m) ** 2).mean(dim=(1, 3), keepdim=True)
        out = ((xr - m) / torch.sqrt(v + eps)).reshape(x.shape) * scale \
            + bias
        return torch.relu(out) if relu else out

    module = resnet.ResNet().to("cuda", torch.float64).to(
        memory_format=torch.channels_last)
    module.load_state_dict({k: v.double() for k, v in
                            spec.params_from_jax(named).items()})
    kernel_gn = resnet.fused_group_norm
    resnet.fused_group_norm = group_norm64
    try:
        logits = module(torch.from_numpy(x).cuda().double())
        F.cross_entropy(logits, torch.from_numpy(y).cuda().long()).backward()
    finally:
        resnet.fused_group_norm = kernel_gn
    return {name: p.grad for name, p in module.named_parameters()}


def training_phase(torch, gn):
    """ResNet-50 at full size trained through the port's trainer."""
    from elasticdl_tpu_torch.models import resnet
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()      # float32 convs in float32: TF32 off
    params = "variant=resnet50;num_classes=1000;image_size=224"
    spec = load_model_spec("resnet", params + ";learning_rate=%g" % TRAIN_LR)
    rng = np.random.RandomState(3)
    batches = [(rng.rand(BATCH, 224, 224, 3).astype(np.float32),
                rng.randint(0, 1000, size=BATCH).astype(np.int32))
               for _ in range(TRAIN_STEPS)]
    out = {}

    named = None

    def run(plain, saver=None):
        nonlocal named
        trainer = CollectiveTrainer(spec, batch_size=BATCH, device="cuda",
                                    checkpoint_saver=saver)
        # Random weights, not the zero-head init: under a zero head every
        # backbone gradient of step 1 is zero and would test nothing.
        named = seeded_params(spec, trainer.module, seed=0)
        trainer.set_params(spec.params_from_jax(named))
        ctx = (plain_group_norm(resnet, gn) if plain
               else contextlib.nullcontext())
        losses, grads = [], None
        with ctx:
            torch.cuda.synchronize()
            gn.LAUNCHES = gn.BWD_LAUNCHES = gn.DY_COPIES = 0
            t0 = time.perf_counter()
            for step, (x, y) in enumerate(batches):
                loss, version = trainer.train_minibatch(x, y)
                losses.append(loss)
                if step == 0:
                    grads = {name: None if p.grad is None
                             else p.grad.detach().clone()
                             for name, p in trainer.module.named_parameters()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (gn.LAUNCHES, gn.BWD_LAUNCHES, gn.DY_COPIES)
        if version != TRAIN_STEPS:
            fail("trainer version %d after %d steps" % (version, TRAIN_STEPS))
        return trainer, [float(l) for l in losses], grads, counts, wall

    _, plain_losses, plain_grads, plain_counts, _ = run(plain=True)
    if plain_counts != (0, 0, 0):
        fail("the plain-GroupNorm trainer launched kernels: %s"
             % (plain_counts,))
    tmp = tempfile.TemporaryDirectory()
    try:
        trainer, losses, grads, counts, wall = run(
            plain=False, saver=CheckpointSaver(tmp.name))
        want = (GN_PER_FORWARD * TRAIN_STEPS, GN_PER_FORWARD * TRAIN_STEPS)
        if counts[:2] != want:
            fail("training launched (forward, backward) kernels %s over %d "
                 "steps, want %s" % (counts[:2], TRAIN_STEPS, want))
        print("train: %d steps, batch %d, f32: launches forward %d, backward "
              "%d, dy copies %d; losses %s (plain GroupNorm %s); wall %.1f "
              "ms incl. set-up" % (TRAIN_STEPS, BATCH, counts[0], counts[1],
                                   counts[2], losses, plain_losses,
                                   wall * 1e3))
        for step, (a, b) in enumerate(zip(losses, plain_losses)):
            if not (math.isfinite(a)
                    and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)):
                fail("step %d loss %r with kernels vs %r plain" % (
                    step + 1, a, b))
        missing = [name for name, g in grads.items()
                   if g is None or not bool(g.isfinite().all())
                   or float(g.abs().max()) == 0.0]
        if missing:
            fail("%d parameters got no gradient (or a zero or non-finite "
                 "one) at step 1: %s" % (len(missing), missing[:5]))
        grads64 = float64_step1_grads(torch, spec, named, *batches[0])

        def rel(a, b):
            return float((a.double() - b.double()).norm() / b.norm())

        errs = {name: (rel(g, plain_grads[name]), rel(g, grads64[name]),
                       rel(plain_grads[name], grads64[name]))
                for name, g in grads.items()}
        for name, (kp, k64, p64) in errs.items():
            if kp > TRAIN_GRAD_RTOL or k64 > 3 * p64 + 1e-4:
                fail("step-1 gradient of %s: norm-relative error %.3g vs "
                     "the plain GroupNorm (limit %g), %.3g vs float64, "
                     "where the plain path is %.3g from float64 (limit "
                     "3x + 1e-4)" % (name, kp, TRAIN_GRAD_RTOL, k64, p64))
        worst = max(errs, key=lambda n: errs[n][0])
        grad_err = {key: max(e[i] for e in errs.values())
                    for i, key in enumerate(("kernel_vs_plain",
                                             "kernel_vs_f64",
                                             "plain_vs_f64"))}
        print("train: every one of %d parameters got a gradient; step-1 "
              "gradients, max norm-relative error over leaves: kernel vs "
              "plain %.3g (%s), kernel vs float64 %.3g, plain vs float64 "
              "%.3g; max loss rel err vs plain %.3g" % (
                  len(grads), grad_err["kernel_vs_plain"], worst,
                  grad_err["kernel_vs_f64"], grad_err["plain_vs_f64"],
                  max(abs(a - b) / abs(b)
                      for a, b in zip(losses, plain_losses))))
        del plain_grads, grads, grads64

        # The loss falls on one batch, repeated.
        x, y = batches[0]
        xd = torch.from_numpy(x).cuda()
        yd = torch.from_numpy(y).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fall = [trainer.train_minibatch(xd, yd)[0] for _ in range(FALL_STEPS)]
        torch.cuda.synchronize()
        out["f32_b32_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / len(
            fall)
        fall = [float(l) for l in fall]
        if not all(map(math.isfinite, fall)) or not fall[-1] < fall[0]:
            fail("loss did not fall over %d steps on one batch: %s"
                 % (FALL_STEPS, fall))
        print("train: one batch x %d: loss %.4f -> %.4f; %.2f ms per step "
              "(batch %d, f32, data on the card)" % (
                  FALL_STEPS, fall[0], fall[-1], out["f32_b32_ms_per_step"],
                  BATCH))

        # Checkpoint round trip: the restored trainer holds the saved
        # parameters and SGD momentum bit for bit (it writes back the
        # same payload), and its next loss is the original's.
        trainer.save_checkpoint()
        trainer.flush_checkpoints()
        saver = CheckpointSaver(tmp.name)
        saved, saved_version = saver.load()
        traces = [k for k in saved if k.startswith("opt/0/trace/")]
        if len(traces) != len(named):
            fail("checkpoint holds %d momentum buffers for %d parameters"
                 % (len(traces), len(named)))
        if not any(np.abs(saved[k]).max() > 0 for k in traces):
            fail("every saved momentum buffer is zero")
        restored = CollectiveTrainer(spec, batch_size=BATCH, device="cuda",
                                     rng_seed=1, checkpoint_saver=saver)
        if not restored.init_from_checkpoint():
            fail("no checkpoint to restore")
        if restored.version != trainer.version:
            fail("restored version %d, saved %d" % (restored.version,
                                                    trainer.version))
        restored.save_checkpoint()      # the same version, rewritten
        restored.flush_checkpoints()
        again, _ = saver.load(saved_version)
        differ = [k for k in saved if k not in again
                  or saved[k].dtype != again[k].dtype
                  or not np.array_equal(saved[k], again[k])]
        if differ or set(again) != set(saved):
            fail("the restored trainer's state differs from the saved one "
                 "in %s" % (differ or sorted(set(again) ^ set(saved)))[:5])
        a = float(trainer.train_minibatch(xd, yd)[0])
        b = float(restored.train_minibatch(xd, yd)[0])
        if a != b:
            fail("restored trainer's next loss %r, the original's %r" % (b, a))
        print("train: checkpoint at version %d (%d arrays, %d momentum "
              "buffers) restored into a fresh trainer bit for bit; next "
              "loss %r on both" % (saved_version, len(saved),
                                   len(traces), a))
        del restored, trainer
    finally:
        tmp.cleanup()
    out.update({"losses": losses, "plain_losses": plain_losses,
                "fall_losses": fall, "launches": counts[:2],
                "dy_copies": counts[2],
                "step1_grad_rel_err": grad_err})

    # bench.py's setting: batch 128, bf16 compute, the spec's learning
    # rate, the zero-head init, data on the card.
    torch.cuda.empty_cache()
    bench_spec = load_model_spec("resnet", params + ";learning_rate=0.1")
    trainer = CollectiveTrainer(bench_spec, batch_size=BENCH_BATCH,
                                device="cuda", use_bf16_compute=True)
    x = torch.from_numpy(rng.rand(BENCH_BATCH, 224, 224, 3).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, size=BENCH_BATCH).astype(
        np.int32)).cuda()
    # Two warm-up steps, every GroupNorm call checked.  Under the
    # zero-head init every backbone gradient of step 1 is zero; step 2's
    # are not, and its backward calls must see a nonzero dy.
    for step in range(2):
        seen = {"fwd_calls": 0, "bwd_calls": 0, "fwd_rel_err": 0.0,
                "bwd_rel_err": 0.0, "min_max_dy": math.inf}
        with checked_group_norm(torch, gn, seen):
            float(trainer.train_minibatch(x, y)[0])
        if (seen["fwd_calls"], seen["bwd_calls"]) != (GN_PER_FORWARD,) * 2:
            fail("bench step %d checked %d forward and %d backward "
                 "GroupNorm calls" % (step + 1, seen["fwd_calls"],
                                      seen["bwd_calls"]))
    if not seen["min_max_dy"] > 0:
        fail("a backward GroupNorm call of bench step 2 got dy = 0")
    print("train bench: step 2, batch %d, bf16 compute: each of the %d "
          "forward and %d backward GroupNorm calls equals its plain "
          "version on the path's tensors (worst error / largest plain "
          "entry: y %.3g, dx %.3g; smallest max|dy| %.3g)" % (
              BENCH_BATCH, seen["fwd_calls"], seen["bwd_calls"],
              seen["fwd_rel_err"], seen["bwd_rel_err"], seen["min_max_dy"]))
    out["bench_path_check"] = seen
    torch.cuda.synchronize()
    gn.LAUNCHES = gn.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(BENCH_STEPS):
        loss, _ = trainer.train_minibatch(x, y)
    loss = float(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / BENCH_STEPS
    if not math.isfinite(loss):
        fail("bf16 training loss %r" % loss)
    if (gn.LAUNCHES, gn.BWD_LAUNCHES) != (GN_PER_FORWARD * BENCH_STEPS,) * 2:
        fail("bf16 training launched %s kernels" % (
            (gn.LAUNCHES, gn.BWD_LAUNCHES),))
    out["bf16_b128_ms_per_step"] = ms
    out["bf16_b128_images_per_s"] = BENCH_BATCH / ms * 1e3
    print("train bench: batch %d, bf16 compute: %.2f ms per step, %.1f "
          "images/s (%d steps, loss %.4f)" % (
              BENCH_BATCH, ms, out["bf16_b128_images_per_s"], BENCH_STEPS,
              loss))
    del trainer
    torch.cuda.empty_cache()
    return out


def live_pairs(T, causal, window):
    """(query, key) pairs attention keeps, per head."""
    if not causal:
        return T * T
    if window:
        w = min(window, T)
        return w * (w + 1) // 2 + (T - w) * w
    return T * (T + 1) // 2


def flash_bound(B, H, T, D, esize, causal, window, part="fwd"):
    """Least time of one flash kernel call: the larger of its compulsory
    bytes over the memory rate and its operations per live (query, key)
    pair over the tensor-core bf16 rate or the f32 rate outside them.
    fwd (B3): q, k, v read, out written, l, m written; 4 D (q k^T, p v).
    dq (B4): q, k, v, out, dO read, dq written, l, m read, delta written;
    6 D (q k^T, dO v^T, ds k).  dkv (B5): q, k, v, dO read, dk, dv
    written, l, m, delta read; 8 D (q k^T, dO v^T, p^T dO, ds^T q).
    partial (B3p): q, k, v read, the f32 acc written, l, m written; 4 D."""
    pairs = live_pairs(T, causal, window)
    tensors, stats, per_pair = {"fwd": (4, 2, 4), "dq": (6, 3, 6),
                                "dkv": (6, 3, 8), "partial": (3, 2, 4)}[part]
    nbytes = tensors * B * H * T * D * esize + stats * B * H * T * 4
    if part == "partial":
        nbytes += B * H * T * D * 4       # the f32 acc written
    flops = per_pair * D * pairs * B * H
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (BF16_FLOPS_PER_S if esize == 2
                      else F32_FLOPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "gflop": flops / 1e9,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def flash_phase(torch, fa):
    """B3 against ``_flash_ref`` at every FLASH_CHECKS shape (out, l and
    m); then, at the flagship long prefill in both dtypes, the kernel's
    time, the plain version's, F.scaled_dot_product_attention's (a
    yardstick the port never calls) and the bound."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, T, D, name, causal, window in FLASH_CHECKS:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        scale = D ** -0.5
        got = fa.flash_forward(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa._flash_ref(q, k, v, causal, scale, window)
        what = "flash_fwd B=%d H=%d T=%d D=%d %s causal=%s window=%d" % (
            B, H, T, D, name, causal, window)
        atol, rtol = FLASH_TOL[name]
        if got[0].dtype != q.dtype or got[0].shape != q.shape:
            fail("%s: out %s %s" % (what, got[0].dtype, tuple(got[0].shape)))
        err = check_close(what, got[0], ref[0], atol, rtol)
        s_max = float((torch.matmul(q.float(), k.float().transpose(-1, -2))
                       * scale).abs().max())
        check_close(what + " m", got[2], ref[2], 1e-5 * s_max, 0.0)
        check_close(what + " l", got[1], ref[1], 0.0, 2e-5)
        max_err[name] = max(max_err[name], err)
        print("check %-62s max_abs_err %.3g" % (what, err))
        del q, k, v, got, ref

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    timed = {}
    for B, H, T, D, name in (FLASH_TIMED + ("bfloat16",),
                             FLASH_TIMED + ("float32",),
                             FLASH_TIMED_D128 + ("bfloat16",)):
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        if (D, name) == (64, "bfloat16"):
            # Every output row has one owner: two runs give the same bits.
            first, again = fa.flash_forward(q, k, v), fa.flash_forward(q, k, v)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                fail("flash_fwd B=%d H=%d T=%d D=%d: two runs are not "
                     "bitwise equal" % (B, H, T, D))
            print("check flash_fwd B=%d H=%d T=%d D=%d %s causal: out, l and "
                  "m bitwise equal across two runs" % (B, H, T, D, name))
            del first, again
        row = {"shape": [B, H, T, D], "dtype": name, "causal": True,
               "ms": time_ms(torch, lambda: fa.flash_forward(q, k, v),
                             flush),
               "plain_ms": time_ms(torch, lambda: fa._flash_ref(
                   q, k, v, True, D ** -0.5), flush, reps=5),
               "library_ms": time_ms(torch, lambda: (
                   F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                   flush)}
        row.update(flash_bound(B, H, T, D, q.element_size(), True, 0))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["over_library"] = row["ms"] / row["library_ms"]
        timed[name if D == 64 else "%s d%d" % (name, D)] = row
        print("time flash_fwd B=%d H=%d T=%d D=%d %s causal: kernel %.4f "
              "ms, plain %.4f ms, scaled_dot_product_attention %.4f ms, "
              "bound %.4f ms (%s; %.2f GFLOP); %.1f %% of the bound, %.2fx "
              "the library" % (
                  B, H, T, D, name, row["ms"], row["plain_ms"],
                  row["library_ms"], row["bound_ms"], row["bound_by"],
                  row["gflop"], 100 * row["bound_share"],
                  row["over_library"]))
        del q, k, v
    del flush
    torch.cuda.empty_cache()
    return max_err, timed


@contextlib.contextmanager
def plain_attention(fa, unrounded=False):
    """Route the transformer's attention to the plain versions of the
    kernels (``flash_attention_ref``: ``_flash_ref`` forward,
    ``_flash_bwd_ref`` backward), on the same tensors; ``unrounded``: to
    the dense f32 softmax ``_attention_ref`` instead, differentiated by
    autograd, which keeps p in f32: the noise floor that the prefill and
    gradient checks read."""
    from elasticdl_tpu_torch.parallel import ring_attention as ra

    kernel = ra.flash_attention

    def unrounded_attention(q, k, v, causal=True, scale=None, window=0):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        return fa._attention_ref(q, k, v, causal, scale, window)

    ra.flash_attention = (unrounded_attention if unrounded
                          else fa.flash_attention_ref)
    try:
        yield
    finally:
        ra.flash_attention = kernel


def host_ms(torch, fn, reps):
    """Median host time of ``fn`` ending in a synchronise, after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_flash_bwd(torch, fa, q, k, v, causal, window, gen, what):
    """B4 and B5 against ``_flash_bwd_ref`` on the forward kernel's
    residuals and a random g; two runs must be bitwise equal.  Returns
    ``bwd_errors``' three readings, each the worst over dq, dk and dv
    (those that are not 0 in exact arithmetic, see BWD_NOISE)."""
    name = str(q.dtype).replace("torch.", "")
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out, l, m = fa.flash_forward(q, k, v, causal=causal, window=window)
    got = fa.flash_backward(q, k, v, out, l, m, g, causal=causal,
                            window=window)
    again = fa.flash_backward(q, k, v, out, l, m, g, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    for part, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            fail("%s %s: two runs are not bitwise equal" % (what, part))
    del again
    ref = fa._flash_bwd_ref(q, k, v, out, l, m, g, causal,
                            q.shape[-1] ** -0.5, window)
    row_tol, norm_tol = FLASH_BWD_TOL[name]
    worst = [0.0, 0.0, 0.0]
    for part, a, r, src in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        if a.dtype != src.dtype or a.shape != src.shape:
            fail("%s %s: %s %s" % (what, part, a.dtype, tuple(a.shape)))
        if not bool(a.isfinite().all()):
            fail("%s %s: non-finite output" % (what, part))
        noise = BWD_NOISE * float(g.double().norm())
        if float(r.double().norm()) < noise:
            if not float(a.double().norm()) < noise:
                fail("%s %s: 0 in exact arithmetic, but ||got|| %.3g >= "
                     "%.3g" % (what, part, float(a.double().norm()), noise))
            continue
        errs = bwd_errors(a, r)
        if not (errs[1] <= row_tol and errs[2] <= norm_tol):
            fail("%s %s: worst row %.3g (limit %g), norm-relative %.3g "
                 "(limit %g)" % (what, part, errs[1], row_tol, errs[2],
                                 norm_tol))
        worst = [max(x, y) for x, y in zip(worst, errs)]
    if (q.shape, name, causal, window) == (
            FLASH_BWD_CHECKS[0][:4], "bfloat16", True, 0):
        gate_self_test(torch, fa, q, k, v, out, l, m, g, got, ref)
    return worst


def gate_self_test(torch, fa, q, k, v, out, l, m, g, got, ref):
    """The gate must reject two faults made from the kernels' own outputs
    at the flagship shape: dk zeroed for the keys past T/2, and dq of the
    last 64 rows without the contribution of the 64-key tile before
    theirs.  Prints the readings of both."""
    T, scale = q.shape[-2], q.shape[-1] ** -0.5
    rows, tile = slice(T - 64, T), slice(T - 128, T - 64)
    # That tile's ds for those rows, as ``_flash_bwd_ref`` makes it (the
    # tile lies wholly below their diagonal: nothing masked).
    p = torch.exp(torch.matmul(q[..., rows, :].float(), k[..., tile, :].float()
                               .transpose(-1, -2)) * scale
                  - m[..., rows, None]) / l[..., rows, None]
    gr = g[..., rows, :].float()
    dp = torch.matmul(gr, v[..., tile, :].float().transpose(-1, -2))
    delta = (gr * out[..., rows, :].float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    bad_dq = got[0].clone()
    bad_dq[..., rows, :] = (bad_dq[..., rows, :].float() - torch.matmul(
        ds, k[..., tile, :].float())).to(q.dtype)
    bad_dk = got[1].clone()
    bad_dk[..., T // 2:, :] = 0
    row_tol, norm_tol = FLASH_BWD_TOL["bfloat16"]
    for what, bad, r in (("dk zeroed past T/2", bad_dk, ref[1]),
                         ("dq of the last 64 rows without one key tile",
                          bad_dq, ref[0])):
        _, row, rel = bwd_errors(bad, r)
        if row <= row_tol and rel <= norm_tol:
            fail("the bf16 backward gate passed a fault (%s): worst row "
                 "%.3g, norm-relative %.3g" % (what, row, rel))
        print("gate self-test: %s: worst row %.3g (limit %g), "
              "norm-relative %.3g (limit %g): rejected"
              % (what, row, row_tol, rel, norm_tol))


def bwd_errors(got, ref):
    """(max abs error, worst row error, norm-relative error) of a gradient
    [..., T, D] against its plain version: a row's error is ||got_r -
    ref_r|| over the larger of ||ref_r|| and the median row norm."""
    got, ref = got.double().flatten(0, -2), ref.double().flatten(0, -2)
    diff = (got - ref).norm(dim=-1)
    norms = ref.norm(dim=-1)
    scale = norms.clamp(min=float(norms.median()))
    return (float((got - ref).abs().max()), float((diff / scale).max()),
            float(diff.norm() / norms.norm()))


def flash_bwd_phase(torch, fa):
    """B4 and B5 against ``_flash_bwd_ref`` at every FLASH_BWD_CHECKS shape,
    bitwise across two runs; then, at the flagship training shape causal
    in both dtypes, each kernel's time and bound, the plain backward's
    time and the backward alone of F.scaled_dot_product_attention through
    autograd (dq, dk and dv together; a yardstick the port never calls)."""
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    # per dtype: (max abs error, worst row error, norm-relative error)
    worst = {"float32": [0.0] * 3, "bfloat16": [0.0] * 3}
    for B, H, T, D, name, causal, window in FLASH_BWD_CHECKS:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        what = "flash_bwd B=%d H=%d T=%d D=%d %s causal=%s window=%d" % (
            B, H, T, D, name, causal, window)
        errs = check_flash_bwd(torch, fa, q, k, v, causal, window, gen, what)
        worst[name] = [max(x, y) for x, y in zip(worst[name], errs)]
        print("check %-62s max_abs_err %.3g, worst row %.3g, "
              "norm-relative %.3g, bitwise-deterministic" % (what, *errs))
        del q, k, v
        torch.cuda.empty_cache()
    for name, (row_tol, norm_tol) in FLASH_BWD_TOL.items():
        print("flash_bwd %s over all shapes: worst row %.3g (limit %g), "
              "norm-relative %.3g (limit %g)" % (
                  name, worst[name][1], row_tol, worst[name][2], norm_tol))

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    timed = {}
    for B, H, T, D, name in (FLASH_TIMED + ("bfloat16",),
                             FLASH_TIMED + ("float32",),
                             FLASH_TIMED_D128 + ("bfloat16",)):
        scale = D ** -0.5
        name_d = name if D == 64 else "%s d%d" % (name, D)
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(4))
        out, l, m = fa.flash_forward(q, k, v)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = fa._bwd_scratch(q)
        launch = {
            "dq": lambda: fa._launch_dq(q, k, v, out, l, m, g, dq, delta,
                                        True, scale, 0),
            "dkv": lambda: fa._launch_dkv(q, k, v, out, l, m, g, dk, dv,
                                          delta, True, scale, 0)}
        launch["dq"]()           # B5 reads the delta that B4 writes
        plain_ms = time_ms(torch, lambda: fa._flash_bwd_ref(
            q, k, v, out, l, m, g, True, scale), flush, reps=5)
        # The backward alone of scaled_dot_product_attention, through
        # autograd on a graph built once.
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            o, (qs, ks, vs), g, retain_graph=True), flush)
        del o, qs, ks, vs
        for part in ("dq", "dkv"):
            row = {"shape": [B, H, T, D], "dtype": name, "causal": True,
                   "ms": time_ms(torch, launch[part], flush),
                   "plain_ms": plain_ms, "library_ms": library_ms}
            row.update(flash_bound(B, H, T, D, q.element_size(), True, 0,
                                   part))
            timed[(part, name_d)] = row
            print("time flash_bwd_%s B=%d H=%d T=%d D=%d %s causal: kernel "
                  "%.4f ms, bound %.4f ms (%s; %.2f GFLOP); whole plain "
                  "backward %.4f ms, scaled_dot_product_attention backward "
                  "%.4f ms" % (part, B, H, T, D, name, row["ms"],
                               row["bound_ms"], row["bound_by"],
                               row["gflop"], plain_ms, library_ms))
        # Each kernel and the pair: the share of the bound reached, and
        # the time over the library's backward (which computes all three).
        pair = {key: timed[("dq", name_d)][key] + timed[("dkv", name_d)][key]
                for key in ("ms", "bound_ms")}
        pair["library_ms"] = library_ms
        timed[("pair", name_d)] = pair
        for part, label in (("dq", "dq (B4)"), ("dkv", "dk, dv (B5)"),
                            ("pair", "B4 + B5")):
            row = timed[(part, name_d)]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["over_library"] = row["ms"] / library_ms
            print("flash_bwd %s %s: %.4f ms, %.1f %% of its bound %.4f ms; "
                  "%.2fx scaled_dot_product_attention's backward %.4f ms" % (
                      label, name_d, row["ms"], 100 * row["bound_share"],
                      row["bound_ms"], row["over_library"], library_ms))
        del q, k, v, g, out, l, m, dq, dk, dv, delta, launch
    del flush
    torch.cuda.empty_cache()
    return worst, timed


def serve_lm(torch, fa, export_dir, prompts, name="lm"):
    """Serve the generation export at ``export_dir`` (a version under a
    base) over HTTP on the card and send one :predict request per batch
    of ``prompts``.  Returns (generated ids per request, latencies ms,
    B3 launches per request, the endpoint)."""
    from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server

    endpoint = ModelEndpoint(os.path.dirname(export_dir), device="cuda")
    server = build_server(endpoint, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    prompt_len, new = prompts.shape[-1], endpoint._snapshot().generate[
        "max_new_tokens"]
    try:
        code, meta = http_json(port, "GET", "/v1/models/" + name)
        if code != 200 or meta["metadata"]["generate"] != {
                "prompt_len": prompt_len, "max_new_tokens": new,
                "temperature": 0.0}:
            fail("%s metadata: %s %s" % (name, code, meta))
        latencies, generated, launches = [], [], []
        for batch in prompts:
            body = json.dumps({"instances": batch.tolist()})
            fa.LAUNCHES = 0
            t0 = time.perf_counter()
            code, resp = http_json(port, "POST",
                                   "/v1/models/%s:predict" % name, body)
            latencies.append((time.perf_counter() - t0) * 1e3)
            launches.append(fa.LAUNCHES)
            if code != 200:
                fail("%s predict: %s %s" % (name, code, resp))
            generated.append(np.asarray(resp["predictions"], np.int64))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    vocab = endpoint._snapshot().module.cfg.vocab_size
    for batch, seq in zip(prompts, generated):
        if seq.shape != (batch.shape[0], prompt_len + new):
            fail("%s generated shape %s" % (name, seq.shape))
        if not np.array_equal(seq[:, :prompt_len], batch):
            fail("%s: the prompt did not come back unchanged" % name)
        if seq.min() < 0 or seq.max() >= vocab:
            fail("%s: generated ids outside the vocab" % name)
    return generated, latencies, launches, endpoint


def teacher_forced_logits(torch, served, cfg, seq, prompt_len):
    """The logits that predict each generated token of ``seq`` [B, T]:
    one forward over the whole sequence, or, for an MoE, prefill over the
    prompt and one decode step per token, as ``generate`` computes them.
    An MoE forward drops the tokens past an expert's capacity in the
    sequence, and a decode step (one token, capacity 1) never does, so
    only the stepwise path computes what was served."""
    from elasticdl_tpu_torch.models import transformer as tfm

    if not cfg.moe_experts:
        return tfm.forward(served, seq, cfg)[:, prompt_len - 1:-1]
    total = seq.shape[1]
    last, caches = tfm.prefill(served, cfg, seq[:, :prompt_len], total)
    rows = [last]
    for t in range(prompt_len, total - 1):
        last, caches = tfm.decode_step(served, cfg, caches, t, seq[:, t])
        rows.append(last)
    return torch.stack(rows, dim=1)


def chosen_gap(rows, chosen):
    """How far below its row's max the logit of each chosen token lies,
    as a share of max|logit|: (the largest gap, the share of tokens whose
    gap exceeds LM_TF_TOL)."""
    gaps = (rows.max(dim=-1).values
            - rows.gather(-1, chosen[..., None])[..., 0])
    gaps = gaps / rows.abs().max()
    return float(gaps.max()), float((gaps > LM_TF_TOL).float().mean())


def check_lm_against_plain(torch, fa, served, cfg, prompts, generated,
                           what):
    """Teacher-force the served tokens through plain attention
    (``teacher_forced_logits``): the logit of each token the kernel path
    chose must lie within LM_TF_TOL of the plain row max; for an MoE,
    the share of tokens past LM_TF_TOL is held to MOE_TF_SHARE or
    LM_FLOOR_X x that share between two equally valid plain paths (the
    plain path's own choices under plain attention with p unrounded),
    whichever is larger.  Then hold the kernel path's prefill logits against plain
    attention's, within the larger of LM_TOL and LM_FLOOR_X x the noise
    floor (plain against unrounded).  Returns the worst readings, each as
    a share of max|logit|."""
    from elasticdl_tpu_torch.models import transformer as tfm

    prompt_len = prompts.shape[-1]
    total = generated[0].shape[1]
    out = {"teacher_forced_worst_gap": 0.0, "teacher_forced_floor": 0.0,
           "teacher_forced_share_over": 0.0, "floor_share_over": 0.0,
           "prefill_rel_err_bf16": 0.0,
           "prefill_rel_err_bf16_p_unrounded": 0.0}

    def worst(key, value):
        out[key] = max(out[key], value)

    with torch.inference_mode():
        for seq in generated:
            seq_d = torch.from_numpy(seq).cuda()
            prompt = seq_d[:, :prompt_len]
            before = fa.LAUNCHES
            with plain_attention(fa):
                rows = teacher_forced_logits(torch, served, cfg, seq_d,
                                             prompt_len)
                plain_last, _ = tfm.prefill(served, cfg, prompt, total)
            with plain_attention(fa, unrounded=True):
                rows_u = teacher_forced_logits(torch, served, cfg, seq_d,
                                               prompt_len)
                unrounded_last, _ = tfm.prefill(served, cfg, prompt, total)
            if fa.LAUNCHES != before:
                fail("the plain-attention path launched the kernel")
            gap, over = chosen_gap(rows, seq_d[:, prompt_len:])
            floor_gap, floor_over = chosen_gap(rows_u, rows.argmax(dim=-1))
            del rows, rows_u
            if cfg.moe_experts:
                limit = max(MOE_TF_SHARE, LM_FLOOR_X * floor_over)
                if over > limit:
                    fail("%s teacher forcing: %.2f %% of the chosen tokens' "
                         "plain logits lie over %g x max|logit| below the "
                         "plain row max (limit %.2f %%; plain vs plain %.2f "
                         "%%)" % (what, 100 * over, LM_TF_TOL, 100 * limit,
                                  100 * floor_over))
            elif gap > LM_TF_TOL:
                fail("%s teacher forcing: a chosen token's plain logit lies "
                     "%.3g x max|logit| below the plain row max (limit %g)"
                     % (what, gap, LM_TF_TOL))
            worst("teacher_forced_worst_gap", gap)
            worst("teacher_forced_floor", floor_gap)
            worst("teacher_forced_share_over", over)
            worst("floor_share_over", floor_over)
            kernel_last, _ = tfm.prefill(served, cfg, prompt, total)
            scale_p = float(plain_last.abs().max())
            floor = float(
                (unrounded_last - plain_last).abs().max()) / scale_p
            limit = max(LM_TOL["bfloat16"], LM_FLOOR_X * floor)
            err = check_close("%s prefill logits bf16, kernel vs plain"
                              % what, kernel_last, plain_last,
                              limit * scale_p, 0.0)
            worst("prefill_rel_err_bf16", err / scale_p)
            worst("prefill_rel_err_bf16_p_unrounded", floor)
    print("%s check: teacher-forced over %d x %d generated tokens, worst "
          "chosen-token gap to the plain row max %.3g x max|logit| (%s; "
          "plain vs plain %.3g), tokens over %g: %.2f %% (plain vs plain: "
          "%.2f %%); prefill logits, "
          "kernel vs plain, bf16: max err %.3g x max|logit| (limit the "
          "larger of %g and %g x the noise floor: plain vs plain with p "
          "unrounded, %.3g)"
          % (what, sum(g.shape[0] for g in generated), total - prompt_len,
             out["teacher_forced_worst_gap"],
             "the share over %g held to the larger of %g %% and %g x plain "
             "vs plain" % (LM_TF_TOL, 100 * MOE_TF_SHARE, LM_FLOOR_X)
             if cfg.moe_experts else "limit %g" % LM_TF_TOL,
             out["teacher_forced_floor"], LM_TF_TOL,
             100 * out["teacher_forced_share_over"],
             100 * out["floor_share_over"], out["prefill_rel_err_bf16"],
             LM_TOL["bfloat16"], LM_FLOOR_X,
             out["prefill_rel_err_bf16_p_unrounded"]))
    return out


@contextlib.contextmanager
def checked_attention(fa, errs):
    """Hold every flash attention call of the transformer against its
    plain version (``flash_attention_ref``) on the same q, k, v, within
    FLASH_TOL; appends each call's max abs error to ``errs``."""
    from elasticdl_tpu_torch.parallel import ring_attention as ra

    kernel = ra.flash_attention

    def checked(q, k, v, causal=True, scale=None, window=0):
        out = kernel(q, k, v, causal=causal, scale=scale, window=window)
        ref = fa.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                     window=window)
        name = str(q.dtype).replace("torch.", "")
        errs.append(check_close(
            "attention call %d on the path's tensors %s" % (len(errs),
                                                            tuple(q.shape)),
            out, ref, *FLASH_TOL[name]))
        return out

    ra.flash_attention = checked
    try:
        yield
    finally:
        ra.flash_attention = kernel


def transformer_phase(torch, fa, tmp):
    """The flagship transformer LM (436 M parameters, seeded random
    weights, bf16 compute) exported with the port's ``export_generate``
    under ``tmp`` (kept: the LoRA phase adapts it), served by the port's
    HTTP server on the card and queried with REQUESTS :predict requests
    of LM_BATCH prompts; then checked against the same module on plain
    attention and timed."""
    import dataclasses

    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()   # as the serving entry point: TF32 off
    spec = load_model_spec("transformer", LM_PARAMS)
    cfg = spec.config
    out = {}
    module = spec.init_fn("cuda", seed=0)
    out["parameters"] = sum(p.numel() for p in module.parameters())
    prompts = np.random.RandomState(4).randint(
        0, cfg.vocab_size, size=(REQUESTS, LM_BATCH, LM_PROMPT)).astype(
            np.int32)
    export_dir = os.path.join(tmp, "lm", "1")
    t0 = time.perf_counter()
    tfm.export_generate(export_dir, module, cfg, max_new_tokens=LM_NEW,
                        prompt_len=LM_PROMPT, model_name="lm", version=1)
    out["export_s"] = time.perf_counter() - t0
    out["export_dir"] = export_dir
    del module
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    generated, latencies, per_request, endpoint = serve_lm(
        torch, fa, export_dir, prompts)
    out["serve_s"] = time.perf_counter() - t0
    launches = sum(per_request)
    if per_request != [cfg.num_layers] * REQUESTS:
        fail("flash kernel launched %s times per request, want %d each "
             "(one per layer of prefill)" % (per_request, cfg.num_layers))
    out.update({"launches": launches, "latency_ms": latencies,
                "generated_tokens_per_s": LM_BATCH * LM_NEW / float(
                    np.median(latencies)) * 1e3})
    print("lm serve: %s M parameters, export %.1f s, load and serve %.1f "
          "s; %d requests x %d prompts x (%d + %d) tokens, latency ms %s, "
          "%.1f generated tokens/s (median request); flash launches %d "
          "(%d per request)" % (
              "%.1f" % (out["parameters"] / 1e6), out["export_s"],
              out["serve_s"], REQUESTS, LM_BATCH, LM_PROMPT, LM_NEW,
              ["%.1f" % t for t in latencies],
              out["generated_tokens_per_s"], launches, cfg.num_layers))

    served = endpoint._snapshot().module
    out.update(check_lm_against_plain(torch, fa, served, cfg, prompts,
                                      generated, "lm"))
    with torch.inference_mode():
        # float32 with TF32 off, prompt 2048, batch 2: the same weights.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        long_prompt = torch.from_numpy(np.random.RandomState(6).randint(
            0, cfg.vocab_size, size=(2, cfg.max_seq_len))).cuda()
        kernel_last, _ = tfm.prefill(served, cfg32, long_prompt,
                                     cfg.max_seq_len)
        with plain_attention(fa):
            plain_last, _ = tfm.prefill(served, cfg32, long_prompt,
                                        cfg.max_seq_len)
        scale_p = float(plain_last.abs().max())
        err32 = check_close("lm prefill logits f32 T=2048, kernel vs plain",
                            kernel_last, plain_last,
                            LM_TOL["float32"] * scale_p, 0.0) / scale_p
        print("lm check: prefill logits f32 (TF32 off), batch 2, T=%d, "
              "kernel vs plain: max err %.3g x max|logit| (limit %g)"
              % (cfg.max_seq_len, err32, LM_TOL["float32"]))
        out["prefill_rel_err_f32_t2048"] = err32
        del kernel_last, plain_last

        # Prefill time at batch 8, kernel and plain attention in turns.
        prefill = {}
        for T, reps in ((LM_PROMPT, 10), (cfg.max_seq_len, 3)):
            x = torch.from_numpy(np.random.RandomState(7).randint(
                0, cfg.vocab_size, size=(LM_BATCH, T))).cuda()
            times = {"kernel": [], "plain": []}
            for which in ("kernel", "plain", "plain", "kernel"):
                ctx = (plain_attention(fa) if which == "plain"
                       else contextlib.nullcontext())
                with ctx:
                    times[which].append(host_ms(
                        torch, lambda: tfm.prefill(served, cfg, x, T), reps))
            prefill[T] = {k: float(np.mean(v)) for k, v in times.items()}
            print("lm prefill batch %d, T=%d, bf16: kernel %.2f ms, plain "
                  "attention %.2f ms" % (LM_BATCH, T, prefill[T]["kernel"],
                                         prefill[T]["plain"]))
        out["prefill_ms"] = prefill
    del served, endpoint
    torch.cuda.empty_cache()
    return out


def zero_flash_counts(fa):
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0


def flash_counts(fa):
    return fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES


def norm_rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def lm_step1(torch, fa, spec, module, toks, attention=None):
    """One step-1 forward and backward through the zoo entry's apply_fn
    and loss_fn: (loss, gradients by name, flash launches)."""
    module.zero_grad(set_to_none=True)
    zero_flash_counts(fa)
    with attention or contextlib.nullcontext():
        loss = spec.loss_fn(spec.apply_fn(module, toks, True), toks).mean()
        loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {name: p.grad for name, p in
                                  module.named_parameters()}, flash_counts(fa)


def lm_grads_vs_plain(torch, fa, spec, module, toks, what, unrounded=None):
    """Step-1 gradients with the kernels (remat: B3 48, B4 24, B5 24
    launches) against the plain Function, each leaf within the larger of
    LM_GRAD_MIN and LM_FLOOR_X x its floor (the plain Function against
    autograd through the dense f32 softmax).  Returns (readings, kernel
    gradients, limits by leaf); ``unrounded``, a dict, receives host
    copies of the dense f32 softmax path's gradients."""
    cfg = spec.config
    loss_k, grads_k, counts = lm_step1(torch, fa, spec, module, toks)
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    if counts != want:
        fail("%s step with remat launched (B3, B4, B5) %s, want %s"
             % (what, counts, want))
    loss_p, grads_p, counts = lm_step1(torch, fa, spec, module, toks,
                                       plain_attention(fa))
    if counts != (0, 0, 0):
        fail("the plain Function launched kernels: %s" % (counts,))
    loss_u, grads_u, _ = lm_step1(torch, fa, spec, module, toks,
                                  plain_attention(fa, True))
    floor = {n: norm_rel(grads_p[n], grads_u[n]) for n in grads_p}
    limit = {n: max(LM_GRAD_MIN, LM_FLOOR_X * f) for n, f in floor.items()}
    floor_kernels = {n: norm_rel(grads_k[n], grads_u[n]) for n in grads_k}
    if unrounded is not None:
        unrounded.update({n: g.cpu() for n, g in grads_u.items()})
    del grads_u
    errs = {}
    for n, g in grads_k.items():
        if g is None or not bool(g.isfinite().all()):
            fail("%s step-1 gradient of %s is missing or not finite"
                 % (what, n))
        errs[n] = norm_rel(g, grads_p[n])
        if not errs[n] <= limit[n]:
            fail("%s step-1 gradient of %s: kernels vs plain Function %.3g "
                 "norm-relative, limit %.3g (plain-vs-plain floor %.3g)"
                 % (what, n, errs[n], limit[n], floor[n]))
    del grads_p
    worst = max(errs, key=errs.get)
    ratio = {n: errs[n] / floor[n] if floor[n] else float("inf")
             for n in errs}
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_unrounded": loss_u, "floor_kernels": floor_kernels,
           "grad_rel_err_max": errs[worst], "grad_rel_err_leaf": worst,
           "floor_max": max(floor.values()),
           "floor_leaf": max(floor, key=floor.get),
           "floor_min": min(floor.values()),
           "err_over_floor_max": max(ratio.values()),
           "grad_rel_err": errs, "floor": floor}
    print("lm train check: %s batch %d x %d, step-1 loss %.6f kernels, "
          "%.6f plain Function, %.6f unrounded; gradients, kernels vs plain "
          "Function: worst leaf %s %.3g norm-relative (limit the larger of "
          "%g and %g x its floor); plain-vs-plain floor %.3g to %.3g (max "
          "at %s); worst error / floor %.3g (%s)" % (
              what, toks.shape[0], toks.shape[1], loss_k, loss_p, loss_u,
              worst, errs[worst], LM_GRAD_MIN, LM_FLOOR_X, out["floor_min"],
              out["floor_max"], out["floor_leaf"], out["err_over_floor_max"],
              max(ratio, key=ratio.get)))
    return out, grads_k, limit


def lm_grad_phase(torch, fa, rng):
    """Step-1 gradients of the flagship LM through the zoo entry's apply_fn
    and loss_fn, kernels (remat=True) against the plain Function
    (``lm_grads_vs_plain``): in float32 with TF32 off at batch
    LM_GRAD_BATCH x 2048, where remat=False and xent_chunk=512 are then
    held against remat=True to the same limits; and at the main path's
    settings, bf16 compute at batch LM_TRAIN_BATCH x 2048."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()
    params = LM_PARAMS.replace("dtype=bfloat16", "dtype=float32")
    specs = {name: load_model_spec("transformer", params + extra)
             for name, extra in (("remat", ";remat=true"),
                                 ("no_remat", ";remat=false"),
                                 ("xent_chunk", ";remat=true;xent_chunk=512"))}
    cfg = specs["remat"].config
    module = specs["remat"].init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_GRAD_BATCH, cfg.max_seq_len))).to(DEVICE)
    unrounded = {}
    out, grads_k, limit = lm_grads_vs_plain(
        torch, fa, specs["remat"], module, toks, "f32 (TF32 off)", unrounded)
    loss_k = out["loss_kernels"]

    gaps = {}
    for name in ("no_remat", "xent_chunk"):
        loss, grads, counts = lm_step1(torch, fa, specs[name], module, toks)
        layers_fwd = 1 if name == "no_remat" else 2
        if counts != (layers_fwd * cfg.num_layers, cfg.num_layers,
                      cfg.num_layers):
            fail("f32 step %s launched (B3, B4, B5) %s" % (name, counts))
        rel = {n: norm_rel(g, grads_k[n]) for n, g in grads.items()}
        bad = [n for n in rel if not rel[n] <= limit[n]]
        if bad or not abs(loss - loss_k) <= LM_GRAD_MIN * abs(loss_k):
            fail("%s vs remat=True: loss %r vs %r, leaves over the limit %s"
                 % (name, loss, loss_k, bad[:5]))
        gaps[name] = {"loss_rel": abs(loss - loss_k) / abs(loss_k),
                      "grad_rel_max": max(rel.values())}
        del grads
        print("lm train check: %s vs remat=True (kernels, f32): loss gap "
              "%.3g relative, worst leaf gradient gap %.3g norm-relative"
              % (name, gaps[name]["loss_rel"], gaps[name]["grad_rel_max"]))
    out["settings_gaps"] = gaps
    refs = {"f32": sp1_reference(toks, out, unrounded, params)}
    del grads_k, module
    torch.cuda.empty_cache()

    spec = load_model_spec("transformer", LM_PARAMS + ";remat=true")
    module = spec.init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_TRAIN_BATCH, cfg.max_seq_len))).to(DEVICE)
    unrounded = {}
    bf16, grads_k, limit = lm_grads_vs_plain(torch, fa, spec, module, toks,
                                             "bf16 compute", unrounded)
    loss_k = bf16["loss_kernels"]
    gaps = {}
    for remat in ("false", "dots", "attn"):
        spec_r = load_model_spec("transformer", LM_PARAMS + ";remat=" + remat)
        loss, grads, counts = lm_step1(torch, fa, spec_r, module, toks)
        fwd = cfg.num_layers * (1 if remat == "false" else 2)
        if counts != (fwd, cfg.num_layers, cfg.num_layers):
            fail("bf16 step remat=%s launched (B3, B4, B5) %s" % (remat,
                                                                  counts))
        rel = {n: norm_rel(g, grads_k[n]) for n, g in grads.items()}
        bad = [n for n in rel if not rel[n] <= limit[n]]
        if bad or not abs(loss - loss_k) <= LM_GRAD_MIN * abs(loss_k):
            fail("remat=%s vs remat=True (bf16): loss %r vs %r, leaves over "
                 "the limit %s" % (remat, loss, loss_k, bad[:5]))
        gaps[remat] = {"loss_rel": abs(loss - loss_k) / abs(loss_k),
                       "grad_rel_max": max(rel.values()),
                       "launches": counts}
        del grads
        print("lm train check: remat=%s vs remat=True (kernels, bf16, batch "
              "%d): loss gap %.3g relative, worst leaf gradient gap %.3g "
              "norm-relative (limit the larger of %g and %g x its floor); "
              "launches B3 %d, B4 %d, B5 %d" % (
                  remat, LM_TRAIN_BATCH, gaps[remat]["loss_rel"],
                  gaps[remat]["grad_rel_max"], LM_GRAD_MIN, LM_FLOOR_X,
                  *counts))
    bf16["remat_gaps"] = gaps
    refs["bf16"] = sp1_reference(toks, bf16, unrounded, LM_PARAMS)
    del grads_k, module
    torch.cuda.empty_cache()
    return {"f32": out, "bf16": bf16}, refs


def sp1_reference(toks, check, unrounded, params):
    """What the sp phase holds the ring path to, on the host, for the model
    ``params`` at sp=1 (``lm_grads_vs_plain``'s ``check`` and
    ``unrounded``): the tokens, the kernel path's step-1 loss, the dense
    f32 softmax path's gradients, and each leaf's limit, the larger of
    LM_GRAD_MIN and LM_FLOOR_X x the kernel path's distance from those."""
    return {"tokens": toks.cpu().numpy(), "loss": check["loss_kernels"],
            "params": params + ";remat=true", "grads": unrounded,
            "limit": {n: max(LM_GRAD_MIN, LM_FLOOR_X * f)
                      for n, f in check["floor_kernels"].items()}}


def lm_training_phase(torch, fa):
    """The flagship LM trained through the port's CollectiveTrainer at
    bench_transformer.py's shape (see the module docstring, phase 11)."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rng = np.random.RandomState(9)
    grad_check, refs = lm_grad_phase(torch, fa, rng)
    out = {"grad_check": grad_check}

    spec = load_model_spec("transformer", LM_PARAMS + ";remat=true")
    cfg = spec.config
    B, T = LM_TRAIN_BATCH, cfg.max_seq_len
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEVICE)
    tmp = tempfile.TemporaryDirectory()
    try:
        trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE,
                                    checkpoint_saver=CheckpointSaver(
                                        tmp.name))
        n_params = sum(p.numel() for p in trainer.module.parameters())
        first, counts = counted_step(torch, fa, trainer, tokens, "LM",
                                     nonzero=True)
        print("lm train: %.1f M parameters, batch %d x %d, bf16 compute, "
              "AdamW, remat: step 1 loss %.4f, launches B3 %d, B4 %d, B5 %d; "
              "every one of %d parameters got a finite gradient"
              % (n_params / 1e6, B, T, first, counts[0], counts[1],
                 counts[2], len(list(trainer.module.parameters()))))

        # Timed steps on the same batch: the loss must fall.
        losses, ms, timed = timed_steps(torch, fa, trainer, tokens,
                                        LM_TRAIN_STEPS)
        if timed != tuple(LM_TRAIN_STEPS * c for c in counts):
            fail("timed steps launched %s" % (timed,))
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail("loss did not fall over %d steps on one batch: %s"
                 % (LM_TRAIN_STEPS, losses))
        model_flops = (6 * n_params * B * T + 12 * cfg.head_dim
                       * live_pairs(T, True, cfg.window) * B
                       * cfg.num_heads * cfg.num_layers)
        out.update({"parameters": n_params, "launches_per_step": counts,
                    "losses": [first] + losses, "ms_per_step": ms,
                    "tokens_per_s": B * T / ms * 1e3,
                    "mfu": model_flops / (ms * 1e-3 * BF16_FLOPS_PER_S),
                    "model_tflop_per_step": model_flops / 1e12})
        print("lm train: %d steps on one batch, loss %.4f -> %.4f; %.2f ms "
              "per step, %.0f tokens/s, mfu %.4f (6 N tokens + 12 D x live "
              "pairs x B H L = %.2f TFLOP per step over 989 TFLOP/s)" % (
                  LM_TRAIN_STEPS, losses[0], losses[-1], ms,
                  out["tokens_per_s"], out["mfu"],
                  out["model_tflop_per_step"]))

        # The same steps with the plain Function in place of the kernels.
        with plain_attention(fa):
            trainer.train_minibatch(tokens, tokens)
            torch.cuda.synchronize()
            zero_flash_counts(fa)
            t0 = time.perf_counter()
            for _ in range(LM_PLAIN_STEPS):
                loss = trainer.train_minibatch(tokens, tokens)[0]
            float(loss)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3 / LM_PLAIN_STEPS
        if flash_counts(fa) != (0, 0, 0):
            fail("the plain-attention steps launched kernels")
        out.update({"plain_ms_per_step": plain_ms,
                    "plain_tokens_per_s": B * T / plain_ms * 1e3})
        print("lm train: plain attention Function: %.2f ms per step, %.0f "
              "tokens/s (%d steps)" % (plain_ms, out["plain_tokens_per_s"],
                                       LM_PLAIN_STEPS))

        # Checkpoint round trip: parameters and AdamW moments in the JAX
        # names and layouts, restored bit for bit, the same next loss.
        trainer.save_checkpoint()
        trainer.flush_checkpoints()
        saver = CheckpointSaver(tmp.name)
        saved, saved_version = saver.load()
        mu = [k for k in saved if k.startswith("opt/0/mu/")]
        if (len(mu) != len(list(trainer.module.parameters()))
                or saved["opt/0/mu/embed"].shape != (cfg.vocab_size,
                                                     cfg.dim)
                or int(saved["opt/0/count"]) != trainer.version):
            fail("checkpoint holds %d mu slots, embed's %s, count %s"
                 % (len(mu), saved["opt/0/mu/embed"].shape,
                    saved["opt/0/count"]))
        restored = CollectiveTrainer(spec, batch_size=B, device=DEVICE,
                                     rng_seed=1, checkpoint_saver=saver)
        if not restored.init_from_checkpoint():
            fail("no checkpoint to restore")
        restored.save_checkpoint()      # the same version, rewritten
        restored.flush_checkpoints()
        again, _ = saver.load(saved_version)
        differ = [k for k in saved if k not in again
                  or saved[k].dtype != again[k].dtype
                  or not np.array_equal(saved[k], again[k])]
        if differ or set(again) != set(saved):
            fail("the restored trainer's state differs from the saved one "
                 "in %s" % (differ or sorted(set(again) ^ set(saved)))[:5])
        del saved, again
        a = float(trainer.train_minibatch(tokens, tokens)[0])
        b = float(restored.train_minibatch(tokens, tokens)[0])
        if a != b:
            fail("restored trainer's next loss %r, the original's %r" % (b, a))
        print("lm train: checkpoint at version %d (%d mu + %d nu slots, "
              "embed's [%d, %d]) restored into a fresh trainer bit for bit; "
              "next loss %r on both" % (saved_version, len(mu), len(mu),
                                        cfg.vocab_size, cfg.dim, a))
        del restored, trainer
    finally:
        tmp.cleanup()
    torch.cuda.empty_cache()
    return out, refs


def timed_steps(torch, fa, trainer, tokens, steps):
    """``steps`` training steps on one batch, host clock around them
    ending in a synchronise: (losses, ms per step, launches)."""
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    t0 = time.perf_counter()
    losses = [trainer.train_minibatch(tokens, tokens)[0]
              for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return [float(x) for x in losses], ms, flash_counts(fa)


def counted_step(torch, fa, trainer, tokens, what, nonzero=False):
    """The main path's count: one training step, counters zeroed just
    before it and read just after; the step must launch B3 twice per
    layer (forward and remat recompute), B4 and B5 once, and give every
    trainable parameter a finite gradient (and a nonzero one with
    ``nonzero``).  Returns (loss, counts)."""
    cfg = trainer._spec.config
    torch.cuda.synchronize()
    zero_flash_counts(fa)
    loss = float(trainer.train_minibatch(tokens, tokens)[0])
    torch.cuda.synchronize()
    counts = flash_counts(fa)
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    if counts != want:
        fail("%s: a training step launched (B3, B4, B5) %s, want %s"
             % (what, counts, want))
    bad = [n for n, p in trainer.module.named_parameters()
           if p.requires_grad and (
               p.grad is None or not bool(p.grad.isfinite().all())
               or nonzero and float(p.grad.abs().max()) == 0.0)]
    if bad or not math.isfinite(loss):
        fail("%s step 1: loss %r; parameters without a finite%s gradient: "
             "%s" % (what, loss, " nonzero" if nonzero else "", bad[:5]))
    return loss, counts


def moe_serving_phase(torch, fa, tmp):
    """Flagship-MoE (MOE_PARAMS, seeded random weights, bf16 compute)
    exported with ``export_generate`` (float32 weights, ~10 GB, into
    ``tmp``; the free space is printed first and a shortfall fails),
    served over HTTP with MOE_REQUESTS requests of LM_BATCH prompts (24 B3
    launches each), and held against plain attention as the dense LM."""
    import shutil

    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec

    spec = load_model_spec("transformer", MOE_PARAMS)
    cfg = spec.config
    module = spec.init_fn(DEVICE, seed=0)
    n_params = sum(p.numel() for p in module.parameters())
    need = 4 * n_params
    free = shutil.disk_usage(tmp).free
    print("moe serve: %.1f M parameters, a float32 export of %.2f GB; %.2f "
          "GB free in %s" % (n_params / 1e6, need / 1e9, free / 1e9, tmp))
    if free < 1.1 * need:
        fail("no room for the MoE export: %.2f GB free in %s, it needs "
             "%.2f GB" % (free / 1e9, tmp, need / 1e9))
    export_dir = os.path.join(tmp, "moe", "1")
    t0 = time.perf_counter()
    tfm.export_generate(export_dir, module, cfg, max_new_tokens=LM_NEW,
                        prompt_len=LM_PROMPT, model_name="moe", version=1)
    export_s = time.perf_counter() - t0
    del module
    torch.cuda.empty_cache()
    prompts = np.random.RandomState(14).randint(
        0, cfg.vocab_size, size=(MOE_REQUESTS, LM_BATCH, LM_PROMPT)).astype(
            np.int32)
    t0 = time.perf_counter()
    generated, latencies, per_request, endpoint = serve_lm(
        torch, fa, export_dir, prompts, name="moe")
    serve_s = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(export_dir))
    if per_request != [cfg.num_layers] * MOE_REQUESTS:
        fail("MoE: flash kernel launched %s times per request, want %d "
             "each" % (per_request, cfg.num_layers))
    out = {"parameters": n_params, "export_s": export_s, "serve_s": serve_s,
           "latency_ms": latencies, "launches_per_request": per_request,
           "generated_tokens_per_s": LM_BATCH * LM_NEW / float(
               np.median(latencies)) * 1e3}
    print("moe serve: export %.1f s, load and serve %.1f s; %d requests x "
          "%d prompts x (%d + %d) tokens, latency ms %s, %.1f generated "
          "tokens/s (median request); flash launches per request %s" % (
              export_s, serve_s, MOE_REQUESTS, LM_BATCH, LM_PROMPT, LM_NEW,
              ["%.1f" % t for t in latencies],
              out["generated_tokens_per_s"], per_request))
    served = endpoint._snapshot().module
    # The kernel on the served path's own tensors: each of the first
    # request's prefill attention calls against its plain version; then
    # the served tokens against generate in process.
    errs = []
    with torch.inference_mode(), checked_attention(fa, errs):
        tfm.prefill(served, cfg, torch.from_numpy(prompts[0]).cuda(),
                    LM_PROMPT + LM_NEW)
    local = tfm.generate(served, cfg, prompts[0], LM_NEW).cpu().numpy()
    if len(errs) != cfg.num_layers or not np.array_equal(local,
                                                         generated[0]):
        fail("MoE: %d attention calls checked; %d served tokens differ "
             "from in-process generate" % (
                 len(errs), int((local != generated[0]).sum())))
    out["attention_call_max_abs_err"] = max(errs)
    print("moe check: the first request's %d prefill attention calls, "
          "kernel vs plain on the path's own q, k, v: max abs err %.3g "
          "(bf16 limit %g + %g x |ref|); its served tokens equal in-process "
          "generate" % (len(errs), max(errs), *FLASH_TOL["bfloat16"]))
    out.update(check_lm_against_plain(torch, fa, served, cfg, prompts,
                                      generated, "moe"))
    del served, endpoint
    torch.cuda.empty_cache()
    return out


def moe_training_phase(torch, fa):
    """Flagship-MoE trained at batch LM_TRAIN_BATCH x 2048, bf16 compute,
    AdamW, remat=True: step-1 gradients with the kernels against the plain
    Function leaf by leaf (``lm_grads_vs_plain``), in float32 at batch
    LM_GRAD_BATCH and at the main path's settings, the router and expert
    leaves among them; then through the port's CollectiveTrainer one
    counted step and MOE_TRAIN_STEPS timed steps on one batch (the loss
    must fall), with the mean aux loss before and after."""
    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rng = np.random.RandomState(15)
    out = {}
    # float32 with TF32 off at batch LM_GRAD_BATCH: rounding too small to
    # flip a routing choice, so the leaves are held near their floors.
    use_float32_numerics()
    spec = load_model_spec("transformer", MOE_PARAMS.replace(
        "dtype=bfloat16", "dtype=float32") + ";remat=true")
    cfg = spec.config
    module = spec.init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_GRAD_BATCH, cfg.max_seq_len))).to(DEVICE)
    out["grad_check_f32"], grads_k, _ = lm_grads_vs_plain(
        torch, fa, spec, module, toks, "MoE f32 (TF32 off)")
    del grads_k, module
    torch.cuda.empty_cache()

    spec = load_model_spec("transformer", MOE_PARAMS + ";remat=true")
    cfg = spec.config
    B, T = LM_TRAIN_BATCH, cfg.max_seq_len
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEVICE)
    module = spec.init_fn(DEVICE, seed=0)
    out["grad_check"], grads_k, _ = lm_grads_vs_plain(
        torch, fa, spec, module, tokens.long(), "MoE bf16 compute")
    zero = [n for n in ("layers.w_router", "layers.w_gate", "layers.w_up",
                        "layers.w_down", "layers.wq")
            if not float(grads_k[n].abs().max()) > 0]
    if zero:
        fail("MoE step-1 gradients are zero for %s" % zero)
    del grads_k, module
    torch.cuda.empty_cache()

    trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE)
    with torch.no_grad():
        aux0 = float(tfm.forward(trainer.module, tokens, cfg,
                                 return_aux=True)[1])
    torch.cuda.reset_peak_memory_stats()
    first, counts = counted_step(torch, fa, trainer, tokens, "MoE",
                                 nonzero=True)
    losses, ms, timed = timed_steps(torch, fa, trainer, tokens,
                                    MOE_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if timed != tuple(MOE_TRAIN_STEPS * c for c in counts):
        fail("MoE timed steps launched %s" % (timed,))
    if not all(map(math.isfinite, losses)) or not losses[-1] < first:
        fail("MoE loss did not fall over %d steps on one batch: %s"
             % (MOE_TRAIN_STEPS + 1, [first] + losses))
    with torch.no_grad():
        aux1 = float(tfm.forward(trainer.module, tokens, cfg,
                                 return_aux=True)[1])
    n_params = sum(p.numel() for p in trainer.module.parameters())
    out.update({"parameters": n_params, "launches_per_step": counts,
                "losses": [first] + losses, "ms_per_step": ms,
                "tokens_per_s": B * T / ms * 1e3, "peak_gb": peak,
                "aux_before": aux0, "aux_after": aux1})
    print("moe train: %.1f M parameters, batch %d x %d, bf16 compute, AdamW, "
          "remat: launches B3 %d, B4 %d, B5 %d per step; loss %.4f -> %.4f "
          "over %d steps on one batch; %.2f ms per step, %.0f tokens/s, peak "
          "%.2f GB; mean aux loss %.4f before, %.4f after (1 = balanced, %d "
          "= collapsed)" % (n_params / 1e6, B, T, counts[0], counts[1],
                            counts[2], first, losses[-1], MOE_TRAIN_STEPS + 1,
                            ms, out["tokens_per_s"], peak, aux0, aux1,
                            cfg.moe_experts))
    del trainer
    torch.cuda.empty_cache()
    return out


def remat_phase(torch, fa):
    """The dense flagship LM trained through the port's CollectiveTrainer
    at batch LM_TRAIN_BATCH x 2048, bf16 compute, AdamW, under each remat
    setting: the launches of one counted step, REMAT_STEPS timed steps and
    the peak of allocated memory over them.  (Their step-1 gradients are
    held against remat=True in ``lm_grad_phase``.)"""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rng = np.random.RandomState(16)
    out = {}
    for remat in ("false", "true", "dots", "attn"):
        spec = load_model_spec("transformer", LM_PARAMS + ";remat=" + remat)
        cfg = spec.config
        tokens = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, size=(LM_TRAIN_BATCH, cfg.max_seq_len)
        ).astype(np.int32)).to(DEVICE)
        trainer = CollectiveTrainer(spec, batch_size=LM_TRAIN_BATCH,
                                    device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(fa)
        trainer.train_minibatch(tokens, tokens)
        torch.cuda.synchronize()
        counts = flash_counts(fa)
        fwd = cfg.num_layers * (1 if remat == "false" else 2)
        if counts != (fwd, cfg.num_layers, cfg.num_layers):
            fail("remat=%s: a training step launched (B3, B4, B5) %s"
                 % (remat, counts))
        losses, ms, _ = timed_steps(torch, fa, trainer, tokens, REMAT_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(map(math.isfinite, losses)):
            fail("remat=%s: losses %s" % (remat, losses))
        out[remat] = {"launches_per_step": counts, "ms_per_step": ms,
                      "tokens_per_s": LM_TRAIN_BATCH * cfg.max_seq_len
                      / ms * 1e3, "peak_gb": peak}
        print("lm remat=%s: launches B3 %d, B4 %d, B5 %d per step; %.2f ms "
              "per step (%d steps), %.0f tokens/s, peak allocated %.2f GB"
              % (remat, *counts, ms, REMAT_STEPS, out[remat]["tokens_per_s"],
                 peak))
        del trainer
        torch.cuda.empty_cache()
    return out


def lora_phase(torch, fa, base_export):
    """LoRA on the dense flagship LM (LORA_PARAMS), its base loaded from
    the transformer serving phase's export: at step 0 its logits equal
    the base's; through the port's CollectiveTrainer at batch
    LM_TRAIN_BATCH x 2048, bf16 compute, remat, one counted step and
    LORA_STEPS timed steps (the loss must fall), after which the base is
    bitwise unchanged and only the adapters hold optimizer state; the
    merged weights' forward within bf16 tolerance of the LoRA forward;
    the merged weights exported with ``export_generate`` and served over
    HTTP answer what ``generate`` gives in process."""
    from elasticdl_tpu_torch.models import lora
    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rng = np.random.RandomState(17)
    spec = load_model_spec("lora", LORA_PARAMS + ";base_export="
                           + base_export)
    cfg = spec.config
    B, T = LM_TRAIN_BATCH, cfg.max_seq_len
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEVICE)
    probe = tokens[:2]
    trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE)
    module = trainer.module
    base = {n: p.detach().clone() for n, p in module.base.named_parameters()}
    adapters = [p for n, p in module.named_parameters()
                if n.startswith("lora.")]
    with torch.no_grad():
        lora_logits = spec.apply_fn(module, probe, False)
        if not torch.equal(lora_logits, tfm.forward(module.base, probe, cfg)):
            fail("LoRA at step 0: logits differ from the base's")
    del lora_logits

    first, counts = counted_step(torch, fa, trainer, tokens, "LoRA")
    no_b = [n for n, p in module.named_parameters()
            if n.endswith(".B") and not float(p.grad.abs().max()) > 0]
    if no_b:
        fail("LoRA step 1: zero gradient for %s" % no_b)
    losses, ms, _ = timed_steps(torch, fa, trainer, tokens, LORA_STEPS)
    if not all(map(math.isfinite, losses)) or not losses[-1] < first:
        fail("LoRA loss did not fall over %d steps on one batch: %s"
             % (LORA_STEPS + 1, [first] + losses))
    moved = [n for n, p in module.base.named_parameters()
             if not torch.equal(p, base[n])]
    held = {id(p) for p in trainer._optimizer.state}
    if moved or held != {id(p) for p in adapters}:
        fail("LoRA: base parameters moved %s; optimizer state for %d "
             "tensors, %d adapters" % (moved[:5], len(held), len(adapters)))
    del base

    merged = lora.merged_params(module, spec.lora["scaling"])
    with torch.no_grad():
        want = spec.apply_fn(module, probe, False)
        got = tfm.forward(merged, probe, cfg)
    scale = float(want.abs().max())
    merge_err = check_close("LoRA merged forward vs LoRA forward (bf16)",
                            got, want, LM_TOL["bfloat16"] * scale,
                            0.0) / scale
    del want, got, trainer, module
    torch.cuda.empty_cache()
    export_dir = os.path.join(os.path.dirname(os.path.dirname(base_export)),
                              "lora", "1")
    tfm.export_generate(export_dir, merged, cfg, max_new_tokens=LM_NEW,
                        prompt_len=LM_PROMPT, model_name="lora", version=1)
    prompts = np.random.RandomState(18).randint(
        0, cfg.vocab_size, size=(1, LM_BATCH, LM_PROMPT)).astype(np.int32)
    generated, latencies, per_request, endpoint = serve_lm(
        torch, fa, export_dir, prompts, name="lora")
    del endpoint
    local = tfm.generate(merged, cfg, prompts[0], LM_NEW).cpu().numpy()
    if not np.array_equal(generated[0], local):
        fail("the merged export served %d tokens that in-process generate "
             "on the merged weights does not give"
             % int((generated[0] != local).sum()))
    n_adapter = sum(p.numel() for p in adapters)
    out = {"adapter_parameters": n_adapter, "launches_per_step": counts,
           "losses": [first] + losses, "ms_per_step": ms,
           "tokens_per_s": B * T / ms * 1e3, "merge_rel_err": merge_err,
           "served_launches": per_request, "latency_ms": latencies}
    print("lora: rank %d, alpha %g, targets %s, %d adapter parameters, base "
          "from %s: step 0 logits equal the base's; batch %d x %d, bf16, "
          "remat: launches B3 %d, B4 %d, B5 %d per step; loss %.4f -> %.4f "
          "over %d steps; %.2f ms per step, %.0f tokens/s; base bitwise "
          "unchanged, optimizer state for the %d adapter tensors only; "
          "merged vs LoRA forward %.3g x max|logit| (limit %g); merged "
          "export served %d prompts (%d B3 launches, %.1f ms), tokens equal "
          "in-process generate" % (
              spec.lora["rank"], spec.lora["scaling"] * spec.lora["rank"],
              ",".join(spec.lora["targets"]), n_adapter, base_export, B, T,
              *counts, first, losses[-1], LORA_STEPS + 1, ms,
              out["tokens_per_s"], len(adapters), merge_err,
              LM_TOL["bfloat16"], LM_BATCH, per_request[0], latencies[0]))
    del merged
    torch.cuda.empty_cache()
    return out


# -- sequence parallelism: B3p, ring attention, the SPMD trainer -------------

# B3p (the unnormalised forward, ring attention's block step) against its
# plain version ``_partial_ref``: (B, H, T, D, dtype, causal, window).  The
# sp=2 ring's blocks at the flagship training shape (T/sp = 1024: the
# diagonal block causal, the lower one non-causal) in both dtypes, head_dim
# 128, windows of one and two 64-key tiles, and T at the edges of the
# kernels' 128-row blocks.
PARTIAL_CHECKS = [
    (8, 16, 1024, 64, "bfloat16", True, 0),
    (8, 16, 1024, 64, "bfloat16", False, 0),
    (8, 16, 1024, 64, "float32", True, 0),
    (8, 16, 1024, 64, "float32", False, 0),
    (4, 8, 1024, 128, "bfloat16", True, 0),
    (4, 8, 1024, 128, "float32", False, 0),
    (2, 16, 1024, 64, "bfloat16", True, 64),
    (2, 16, 1024, 64, "bfloat16", True, 128),
    (2, 16, 1, 64, "bfloat16", True, 0),
    (2, 16, 127, 64, "bfloat16", True, 0),
    (2, 16, 129, 64, "bfloat16", False, 0),
    (2, 16, 257, 64, "bfloat16", True, 0),
]
PARTIAL_TIMED = (8, 16, 1024, 64)
# acc is held per row against the row's l: |acc - acc_ref| <= tol x (l_ref
# + |acc_ref|), FLASH_TOL's out tolerance carried to the unnormalised sum:
# float32 2e-5, the JAX oracle's (sums in other orders; 5.9e-7 at most on
# the H100); bfloat16 1e-2, about 3x the largest reading over
# PARTIAL_CHECKS on the H100 (3.2e-3: the kernel rounds p to bf16 against
# its running row max before p v, ``_partial_ref`` keeps p in f32, and acc
# itself is not rounded, so this is one bf16 rounding of p where B3's
# FLASH_TOL allows two).  m within 1e-5 x max|s|, l within 2e-5 relative,
# as for B3.
PARTIAL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# Ring attention against attention_local on one rank (B3, B4, B5), at the
# flagship's attention [B, T, H, D] in bf16 and, at batch 2, in f32: the
# output within FLASH_TOL of attention_local's; dq, dk, dv held by
# ``bwd_errors`` against autograd through the dense f32 softmax on the
# same inputs, within the larger of SP_BWD_TOL and LM_FLOOR_X x
# attention_local's own distance from it (the ring's backward keeps p and
# ds in f32 where the kernels round both to bf16, so ring and
# attention_local sit apart by about that distance; their gap is printed).
# SP_BWD_TOL is FLASH_BWD_TOL but for float32's norm limit: the ring's
# backward sums over 128-key blocks and ranks in another order than the
# dense reference, 8.9e-7 norm-relative from it at most on the H100 where
# attention_local sits 3e-7 away; 3e-6 is about 3x that reading.
SP_BWD_TOL = {"float32": (4e-5, 3e-6), "bfloat16": FLASH_BWD_TOL["bfloat16"]}
# (seed, dtype, batch, window):
SP_ATTENTION_T, SP_HEADS, SP_HEAD_DIM = 2048, 16, 64
SP2_ATTENTION = [(21, "bfloat16", 8, 0), (22, "float32", 2, 0)]
# At sp=4 (shards of 512) a window of 768 keys bands the blocks at ring
# distances 1 and 2 (``_partial_banded``) and skips distance 3.
SP4_ATTENTION = [(23, "bfloat16", 8, 0), (24, "bfloat16", 8, 768)]
SP_TIMED_STEPS = 3
SP4_LAYERS = 4
# A checkpoint saved at sp=2 and restored at sp=1: the loss, and the loss
# after one more step, within SP_LOSS_RTOL of the sp=2 trainer's.  The two
# paths' attention rounds differently in bf16: their step-1 losses on the
# same parameters sit 4.0e-6 apart on the H100, the restored ones 4.1e-7
# and 2.1e-6; 2e-5 is about 5x the largest.  A lost optimizer state or a
# wrong parameter moves the loss after the step by far more.
SP_LOSS_RTOL = 2e-5
SP_RANKS_TIMEOUT_S = 900


def partial_phase(torch, fa):
    """B3p against ``_partial_ref`` at every PARTIAL_CHECKS shape (acc, l,
    m), bitwise across two runs at the ring's shapes; then, at
    PARTIAL_TIMED causal and non-causal in both dtypes, the kernel's time,
    the plain version's and the bound.  No PyTorch call returns the
    unnormalised acc (scaled_dot_product_attention normalises), so there
    is no library time."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = {"float32": 0.0, "bfloat16": 0.0}    # of |err| / (l + |ref|)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, T, D, name, causal, window in PARTIAL_CHECKS:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        scale = D ** -0.5
        before = fa.LAUNCHES, fa.PARTIAL_LAUNCHES
        acc, l, m = fa.flash_partial_forward(q, k, v, causal=causal,
                                             window=window)
        torch.cuda.synchronize()
        what = "flash_partial B=%d H=%d T=%d D=%d %s causal=%s window=%d" % (
            B, H, T, D, name, causal, window)
        if (fa.LAUNCHES, fa.PARTIAL_LAUNCHES) != (before[0], before[1] + 1):
            fail("%s: launches (B3, B3p) went from %s to %s" % (
                what, before, (fa.LAUNCHES, fa.PARTIAL_LAUNCHES)))
        if acc.dtype != torch.float32 or acc.shape != q.shape:
            fail("%s: acc %s %s" % (what, acc.dtype, tuple(acc.shape)))
        if not bool(acc.isfinite().all()):
            fail("%s: non-finite acc" % what)
        ref_acc, ref_l, ref_m = fa._partial_ref(q, k, v, causal, scale, 0,
                                                window)
        rel = float(((acc - ref_acc).abs()
                     / (ref_l[..., None] + ref_acc.abs())).max())
        if not rel <= PARTIAL_TOL[name]:
            fail("%s: acc off by %.3g of (l + |acc|), limit %g"
                 % (what, rel, PARTIAL_TOL[name]))
        s_max = float((torch.matmul(q.float(), k.float().transpose(-1, -2))
                       * scale).abs().max())
        check_close(what + " m", m, ref_m, 1e-5 * s_max, 0.0)
        check_close(what + " l", l, ref_l, 0.0, 2e-5)
        err = float((acc - ref_acc).abs().max())
        worst[name] = max(worst[name], rel)
        max_err[name] = max(max_err[name], err)
        print("check %-66s max_abs_err %.3g, |err| / (l + |acc|) %.3g"
              % (what, err, rel))
        del q, k, v, acc, l, m, ref_acc, ref_l, ref_m

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    timed = {}
    B, H, T, D = PARTIAL_TIMED
    for name in ("bfloat16", "float32"):
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        for causal in (True, False):
            if name == "bfloat16":
                first = fa.flash_partial_forward(q, k, v, causal=causal)
                again = fa.flash_partial_forward(q, k, v, causal=causal)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail("flash_partial B=%d H=%d T=%d D=%d causal=%s: two "
                         "runs are not bitwise equal" % (B, H, T, D, causal))
                print("check flash_partial B=%d H=%d T=%d D=%d %s causal=%s: "
                      "acc, l and m bitwise equal across two runs"
                      % (B, H, T, D, name, causal))
                del first, again
            row = {"shape": [B, H, T, D], "dtype": name, "causal": causal,
                   "ms": time_ms(torch, lambda: fa.flash_partial_forward(
                       q, k, v, causal=causal), flush),
                   "plain_ms": time_ms(torch, lambda: fa._partial_ref(
                       q, k, v, causal, D ** -0.5, 0), flush, reps=5),
                   "library_ms": None}
            row.update(flash_bound(B, H, T, D, q.element_size(), causal, 0,
                                   "partial"))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            timed[(name, causal)] = row
            print("time flash_partial B=%d H=%d T=%d D=%d %s causal=%s: "
                  "kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s; %.2f "
                  "GFLOP, %.1f MB), %.1f %% of the bound" % (
                      B, H, T, D, name, causal, row["ms"], row["plain_ms"],
                      row["bound_ms"], row["bound_by"], row["gflop"],
                      row["bytes_ms"] * 1e-3 * HBM_BYTES_PER_S / 1e6,
                      100 * row["bound_share"]))
        del q, k, v
    del flush
    torch.cuda.empty_cache()
    return worst, max_err, timed


def sp_inputs(torch, seed, name, batch):
    """The global q, k, v and output gradient g [B, T, H, D] of one ring
    attention case, the same in every process (a seeded generator on the
    card)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(batch, SP_ATTENTION_T, SP_HEADS, SP_HEAD_DIM,
                        generator=gen, device=DEVICE).to(getattr(torch, name))
            for _ in range(4)]


def sp_attention_reference(torch, fa, case):
    """On the host: attention_local's output and (dq, dk, dv) on one rank
    (B3, B4, B5), and the gradients of autograd through the dense f32
    softmax on the same inputs."""
    from elasticdl_tpu_torch.parallel import ring_attention as ra

    seed, name, batch, window = case
    q, k, v, g = sp_inputs(torch, seed, name, batch)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = ra.attention_local(*leaves, causal=True, window=window)
    o.backward(g)
    local = [o.detach().cpu()] + [t.grad.cpu() for t in leaves]
    dense = [t.detach().float().requires_grad_() for t in (q, k, v)]
    od = fa._attention_ref(*(t.transpose(1, 2) for t in dense), True,
                           SP_HEAD_DIM ** -0.5, window).transpose(1, 2)
    od.backward(g.float())
    dense = [t.grad.cpu() for t in dense]
    del q, k, v, g, leaves, o, od
    torch.cuda.empty_cache()
    return local, dense


def sp_check_attention(case, local, dense, shards, sp):
    """Each rank's ring output against attention_local's block, and its
    gradients against the dense f32 softmax's, as far from them as
    attention_local is at most LM_FLOOR_X times (SP2_ATTENTION's comment);
    returns the readings: (worst row, norm-relative) per gradient, for the
    ring and attention_local against dense f32 and for the ring against
    attention_local."""
    seed, name, batch, window = case
    row_tol, norm_tol = SP_BWD_TOL[name]
    atol, rtol = FLASH_TOL[name]
    what = "ring attention sp=%d [%d, %d, %d, %d] %s window=%d" % (
        sp, batch, SP_ATTENTION_T, SP_HEADS, SP_HEAD_DIM, name, window)
    tl = SP_ATTENTION_T // sp
    floor = [bwd_errors(a.float(), d)[1:] for a, d in zip(local[1:], dense)]
    out = {"out_max_abs_err": 0.0, "ring_vs_dense": [[0.0, 0.0]] * 3,
           "ring_vs_local": [[0.0, 0.0]] * 3, "local_vs_dense": floor}
    for rank, got in enumerate(shards):
        block = slice(rank * tl, (rank + 1) * tl)
        err = check_close("%s rank %d out" % (what, rank), got[0],
                          local[0][:, block], atol, rtol)
        out["out_max_abs_err"] = max(out["out_max_abs_err"], err)
        for i, part in enumerate(("dq", "dk", "dv")):
            if not bool(got[1 + i].isfinite().all()):
                fail("%s rank %d %s: non-finite" % (what, rank, part))
            row, rel = bwd_errors(got[1 + i].float(),
                                  dense[i][:, block])[1:]
            row_lim = max(row_tol, LM_FLOOR_X * floor[i][0])
            norm_lim = max(norm_tol, LM_FLOOR_X * floor[i][1])
            if not (row <= row_lim and rel <= norm_lim):
                fail("%s rank %d %s against dense f32: worst row %.3g "
                     "(limit %.3g), norm-relative %.3g (limit %.3g)" % (
                         what, rank, part, row, row_lim, rel, norm_lim))
            gap = bwd_errors(got[1 + i], local[1 + i][:, block])[1:]
            out["ring_vs_dense"][i] = [
                max(a, b) for a, b in zip(out["ring_vs_dense"][i], (row, rel))]
            out["ring_vs_local"][i] = [
                max(a, b) for a, b in zip(out["ring_vs_local"][i], gap)]
    print("check %s: out vs attention_local (B3/B4/B5) max abs err %.3g; "
          "dq, dk, dv (worst row, norm-relative) against dense f32: ring %s, "
          "attention_local %s; ring against attention_local %s" % (
              what, out["out_max_abs_err"],
              *("; ".join("%.3g, %.3g" % tuple(x) for x in out[key])
                for key in ("ring_vs_dense", "local_vs_dense",
                            "ring_vs_local"))))
    return out


def sp_counts(fa):
    return (fa.LAUNCHES, fa.PARTIAL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
            fa.BWD_DKV_LAUNCHES)


def sp_zero_counts(fa):
    zero_flash_counts(fa)
    fa.PARTIAL_LAUNCHES = 0


def sp_model_leg(torch, fa, mesh, leg):
    """One model leg in a rank: the SPMD trainer over ``mesh`` from the
    zoo entry's seeded init, its step-1 loss and gradients (summed over the
    ranks), which rank 0 holds leaf by leaf to the sp=1 dense f32 softmax
    path's within the leaf's limit (``sp1_reference``), and with
    ``leg["train"]`` one counted step, timed steps and a checkpoint."""
    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.parallel.spmd_trainer import SPMDTrainer
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    spec = load_model_spec("transformer", leg["params"])
    cfg = spec.config
    rank, sp = mesh.coords["sp"], mesh.shape["sp"]

    def loss_fn(module, batch):
        toks, targets = batch
        logits = tfm.forward(module, toks, cfg, mesh=mesh)
        return tfm.next_token_loss_sum(logits, targets), (targets >= 0).sum()

    trainer = SPMDTrainer(mesh, spec.init_fn, loss_fn, spec.optimizer,
                          param_specs=tfm.param_specs(cfg))
    toks = torch.from_numpy(leg["tokens"]).long()
    batch = (toks, tfm.next_token_targets(toks))
    want = (0, 2 * cfg.num_layers * (rank + 1), 0, 0)
    torch.cuda.synchronize()
    sp_zero_counts(fa)
    loss = float(trainer.compute_gradients(batch))
    torch.cuda.synchronize()
    out = {"name": leg["name"], "rank": rank, "step1_loss": loss,
           "step1_launches": sp_counts(fa)}
    if out["step1_launches"] != want:
        raise RuntimeError("%s rank %d: step 1 launched (B3, B3p, B4, B5) "
                           "%s, want %s" % (leg["name"], rank,
                                            out["step1_launches"], want))
    if rank == 0:
        grads = torch.load(leg["grads_path"])
        errs = {}
        for n, p in trainer.module.named_parameters():
            if p.grad is None or not bool(p.grad.isfinite().all()):
                raise RuntimeError("%s: gradient of %s missing or not "
                                   "finite" % (leg["name"], n))
            errs[n] = norm_rel(p.grad, grads[n].to(p.device))
        del grads
        bad = [n for n in errs if not errs[n] <= leg["limit"][n]]
        if bad:
            raise RuntimeError(
                "%s: step-1 gradients of %s off the sp=1 dense f32 softmax "
                "path's: %s (limits %s)" % (
                    leg["name"], bad[:5], [errs[n] for n in bad[:5]],
                    [leg["limit"][n] for n in bad[:5]]))
        worst = max(errs, key=errs.get)
        out.update({"grad_rel_err_max": errs[worst],
                    "grad_rel_err_leaf": worst,
                    "err_over_limit_max": max(errs[n] / leg["limit"][n]
                                              for n in errs)})
    if leg["train"]:
        torch.cuda.synchronize()
        sp_zero_counts(fa)
        counted = float(trainer.train_step(batch))
        torch.cuda.synchronize()
        counts = sp_counts(fa)
        if counts != want:
            raise RuntimeError("%s rank %d: a training step launched (B3, "
                               "B3p, B4, B5) %s, want %s"
                               % (leg["name"], rank, counts, want))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch) for _ in range(SP_TIMED_STEPS)]
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SP_TIMED_STEPS
        if not all(map(math.isfinite, losses)) or not losses[-1] < counted:
            raise RuntimeError("%s: the loss did not fall: %s" % (
                leg["name"], [counted] + losses))
        out.update({"launches_per_step": counts, "losses": [counted] + losses,
                    "ms_per_step": ms,
                    "tokens_per_s": toks.numel() / sp / ms * 1e3,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        trainer.save_checkpoint(CheckpointSaver(leg["ckpt_dir"]))
        version, loss = trainer.version, float(trainer.eval_loss(batch))
        trainer.train_step(batch)
        out["saved"] = (version, loss, float(trainer.eval_loss(batch)))
    del trainer
    torch.cuda.empty_cache()
    return out


def sp_rank(sp, attention, legs):
    """One rank of an ``sp`` world on the card (gloo groups, host-staged
    transport): the ring attention cases, then the model legs."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.ring_attention import ring_attention
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()
    mesh = build_mesh(sp=sp, backend="gloo")
    rank, tl = mesh.coords["sp"], SP_ATTENTION_T // sp
    out = {"rank": rank, "device": str(mesh.device), "attention": []}
    for seed, name, batch, window in attention:
        q, k, v, g = (t[:, rank * tl:(rank + 1) * tl]
                      for t in sp_inputs(torch, seed, name, batch))
        leaves = [t.contiguous().requires_grad_() for t in (q, k, v)]
        o = ring_attention(*leaves, mesh, causal=True, window=window)
        o.backward(g)
        out["attention"].append([o.detach().cpu()]
                                + [t.grad.cpu() for t in leaves])
        del q, k, v, g, leaves, o
    out["legs"] = [sp_model_leg(torch, fa, mesh, leg) for leg in legs]
    return out


def sp_spawn(sp, attention, legs):
    from elasticdl_tpu_torch.parallel import launch

    try:
        return launch.spawn(sp_rank, sp, (sp, attention, legs),
                            timeout=SP_RANKS_TIMEOUT_S)
    except RuntimeError as e:
        fail("sp=%d ranks: %s" % (sp, e))


def sp_leg(name, ref, tmp, train, ckpt_dir):
    """A model leg's arguments, the sp=1 gradients saved for rank 0."""
    import torch

    path = os.path.join(tmp, name + ".pt")
    torch.save(ref["grads"], path)
    return {"name": name, "params": ref["params"], "tokens": ref["tokens"],
            "limit": ref["limit"], "grads_path": path, "train": train,
            "ckpt_dir": ckpt_dir}


def sp_phase(torch, fa, lm_refs):
    """Sequence parallelism on the card (module docstring, phase 16)."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    out = {}
    t0 = time.perf_counter()
    out["partial_worst"], out["partial_max_abs_err"], out["partial_timed"] = (
        partial_phase(torch, fa))
    out["partial_s"] = time.perf_counter() - t0

    # The 4-layer model's sp=1 reference, as the flagship's (lm_grad_phase).
    params4 = LM_PARAMS.replace("num_layers=24", "num_layers=%d" % SP4_LAYERS)
    spec4 = load_model_spec("transformer", params4 + ";remat=true")
    module = spec4.init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(lm_refs["bf16"]["tokens"]).to(DEVICE)
    unrounded = {}
    check, grads_k, _ = lm_grads_vs_plain(torch, fa, spec4, module, toks,
                                          "%d-layer bf16" % SP4_LAYERS,
                                          unrounded)
    ref4 = sp1_reference(toks, check, unrounded, params4)
    del module, grads_k, unrounded
    torch.cuda.empty_cache()

    tmp = tempfile.TemporaryDirectory()
    try:
        ckpt_dir = os.path.join(tmp.name, "ckpt")
        worlds = {}
        for sp, cases, leg_refs in (
                (2, SP2_ATTENTION, [("f32 batch 2", lm_refs["f32"], False),
                                    ("bf16 batch 8", lm_refs["bf16"], True)]),
                (4, SP4_ATTENTION, [("%d-layer bf16 batch 8" % SP4_LAYERS,
                                     ref4, False)])):
            legs = [sp_leg(name, ref, tmp.name, train, ckpt_dir)
                    for name, ref, train in leg_refs]
            refs = [sp_attention_reference(torch, fa, c) for c in cases]
            t0 = time.perf_counter()
            ranks = sp_spawn(sp, cases, legs)
            out["sp%d_s" % sp] = time.perf_counter() - t0
            out["sp%d_attention" % sp] = [
                sp_check_attention(c, local, dense,
                                   [r["attention"][i] for r in ranks], sp)
                for i, (c, (local, dense)) in enumerate(zip(cases, refs))]
            del refs
            for i, (leg, (_, ref, _)) in enumerate(zip(legs, leg_refs)):
                got = [r["legs"][i] for r in ranks]
                for r in got:
                    r["step1_loss_rel_gap"] = abs(
                        r["step1_loss"] - ref["loss"]) / abs(ref["loss"])
                print("sp=%d %s: step-1 loss %.6f (sp=1 kernels %.6f, gap "
                      "%.3g relative), launches per rank (B3, B3p, B4, B5) "
                      "%s; gradients summed over the ranks against sp=1's "
                      "dense f32 softmax path: worst leaf %s %.3g "
                      "norm-relative, %.3g of its limit" % (
                          sp, leg["name"], got[0]["step1_loss"], ref["loss"],
                          got[0]["step1_loss_rel_gap"],
                          [r["step1_launches"] for r in got],
                          got[0]["grad_rel_err_leaf"],
                          got[0]["grad_rel_err_max"],
                          got[0]["err_over_limit_max"]))
            worlds[sp] = ranks
            out["sp%d_legs" % sp] = [[r["legs"][i] for r in ranks]
                                     for i in range(len(legs))]

        train = [r["legs"][1] for r in worlds[2]]
        for r in train:
            print("sp=2 train rank %d (%s): %d steps on one batch, loss %s; "
                  "%.2f ms per step, %.0f tokens/s on the rank, peak "
                  "allocated %.2f GB; launches (B3, B3p, B4, B5) %s" % (
                      r["rank"], worlds[2][r["rank"]]["device"],
                      SP_TIMED_STEPS + 1,
                      " -> ".join("%.4f" % x for x in r["losses"]),
                      r["ms_per_step"], r["tokens_per_s"], r["peak_gb"],
                      r["launches_per_step"]))
        # The checkpoint saved at sp=2, restored at sp=1 in this process.
        spec = load_model_spec("transformer", lm_refs["bf16"]["params"])
        version, loss2, next2 = train[0]["saved"]
        restored = CollectiveTrainer(spec, batch_size=toks.shape[0],
                                     device=DEVICE,
                                     checkpoint_saver=CheckpointSaver(
                                         ckpt_dir))
        if not restored.init_from_checkpoint() or restored.version != version:
            fail("the sp=2 checkpoint did not restore at sp=1")
        def loss_now():
            with torch.no_grad():
                return float(spec.loss_fn(spec.apply_fn(
                    restored.module, toks, True), toks).mean())

        loss1 = loss_now()
        restored.train_minibatch(toks, toks)
        next1 = loss_now()
        gaps = (abs(loss1 - loss2) / abs(loss2),
                abs(next1 - next2) / abs(next2))
        if not max(gaps) <= SP_LOSS_RTOL:
            fail("checkpoint saved at sp=2 (version %d), restored at sp=1: "
                 "loss %r vs %r, next step %r vs %r (limit %g relative)"
                 % (version, loss1, loss2, next1, next2, SP_LOSS_RTOL))
        out["checkpoint"] = {"version": version, "sp2": [loss2, next2],
                             "sp1": [loss1, next1], "rel_gaps": gaps}
        print("checkpoint saved at sp=2 (version %d) restored at sp=1: loss "
              "%.6f vs %.6f, next step %.6f vs %.6f (gaps %.3g, %.3g "
              "relative, limit %g)" % (version, loss1, loss2, next1, next2,
                                       gaps[0], gaps[1], SP_LOSS_RTOL))
        del restored
    finally:
        tmp.cleanup()
    torch.cuda.empty_cache()
    return out


# The master/worker process path (phase 17).  Leg 1: the flagship at full
# width and depth (remat) trained in this process through the port's
# master (TaskManager + gRPC servicer) and Worker task loop, PROC_TASKS
# tasks of PROC_MINIBATCHES minibatches at batch LM_TRAIN_BATCH x 2048
# (synthetic_lm: arithmetic token sequences), PROC_JOBS such jobs in
# turn with PROC_DIRECT_STEPS direct CollectiveTrainer steps on one batch
# before, between and after them, for the task loop's overhead.  Leg 2: the master CLI with 2 worker processes on the
# card, the flagship's widths at CLI_LAYERS layers (100.7 M parameters,
# a 1.21 GB checkpoint of parameters and AdamW moments), worker 0
# killed -9 after its first checkpoint; both workers start from an empty
# kernel cache (ELASTICDL_TORCH_BUILD_DIR), so they build B3-B5 side by
# side, and the replacement loads the cached libraries.
PROC_MINIBATCHES = 4
PROC_TASKS = 4
PROC_DIRECT_STEPS = 5
PROC_JOBS = 2
CLI_LAYERS = 4
CLI_PARAMS = ("vocab_size=32768;dim=1024;num_heads=16;num_layers=%d;"
              "seq_len=2048;dtype=bfloat16;remat=true" % CLI_LAYERS)
# 160 tasks of 4 minibatches: enough that the surviving worker cannot
# finish the job before the replacement's first step.
CLI_RECORDS = 5120
CLI_CHECKPOINT_STEPS = 8
CLI_TIMEOUT_S = 420


def process_leg(torch, fa):
    """Leg 1: the flagship through the master servicer and the Worker in
    this process; returns the leg's numbers."""
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.master.task_manager import TaskManager
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.proto import elastic_pb2 as pb
    from elasticdl_tpu_torch.utils import grpc_utils
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    B = LM_TRAIN_BATCH
    per_task = B * PROC_MINIBATCHES
    n = PROC_TASKS * PROC_MINIBATCHES
    spec = load_model_spec("transformer", LM_PARAMS + ";remat=true")
    cfg = spec.config
    T = cfg.max_seq_len
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    reader = create_data_reader("synthetic_lm:%d:%d:%d" % (
        per_task * PROC_TASKS, T, cfg.vocab_size),
        records_per_shard=per_task)
    trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE)
    # The direct step: random tokens already on the card (no task loop,
    # no host copy), on the same trainer, timed before, between and after
    # the Worker's jobs; the task loop's cost is the gap to their steps.
    tokens = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEVICE)

    def direct_ms():
        _, ms, counts = timed_steps(torch, fa, trainer, tokens,
                                    PROC_DIRECT_STEPS)
        if counts != tuple(PROC_DIRECT_STEPS * w for w in want):
            fail("the direct steps launched %s" % (counts,))
        return ms

    def job():
        """One job of PROC_TASKS tasks: a master, a Worker, the counts
        zeroed just before its run and read just after."""
        master = Master(TaskManager(training_shards=reader.create_shards(),
                                    records_per_task=per_task,
                                    num_epochs=1))
        master.prepare()
        inner = trainer.train_minibatch
        try:
            channel = grpc_utils.build_channel("localhost:%d" % master.port)
            grpc_utils.wait_for_channel_ready(channel, timeout=60)
            mc = MasterClient(channel, worker_id=0)
            # Each step's loss and launches; one synchronise after step 1
            # so the steps after it time the loop in its steady state.
            steps, marks = [], {}

            def train_minibatch(features, labels):
                before = flash_counts(fa)
                loss, version = inner(features, labels)
                steps.append((loss, tuple(
                    a - b for a, b in zip(flash_counts(fa), before))))
                if len(steps) == 1:
                    torch.cuda.synchronize()
                    marks["first"] = time.perf_counter()
                return loss, version

            trainer.train_minibatch = train_minibatch
            worker = Worker(mc, reader, spec, trainer, batch_size=B)
            torch.cuda.synchronize()
            zero_flash_counts(fa)
            t0 = time.perf_counter()
            worker.run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = flash_counts(fa)
            task_counts = master.task_manager.counts()
        finally:
            trainer.train_minibatch = inner
            master.stop()
        if not master.task_manager.finished() or task_counts["completed"][
                pb.TRAINING] != PROC_TASKS or sum(
                    task_counts["failed"].values()):
            fail("the in-process job did not finish its %d tasks: %s"
                 % (PROC_TASKS, task_counts))
        if len(steps) != n or any(c != want for _, c in steps):
            fail("the Worker ran %d steps (want %d) launching (B3, B4, B5) "
                 "%s (want %s each)" % (len(steps), n,
                                        sorted({c for _, c in steps}), want))
        if counts != tuple(n * w for w in want):
            fail("the Worker's run launched (B3, B4, B5) %s, want %s"
                 % (counts, tuple(n * w for w in want)))
        losses = [float(loss) for loss, _ in steps]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail("the Worker's loss did not fall: %s" % losses)
        return {"ms_per_step": (t1 - marks["first"]) * 1e3 / (n - 1),
                "first_step_s": marks["first"] - t0, "losses": losses,
                "launches": counts, "timing": worker.timing.summary()}

    float(trainer.train_minibatch(tokens, tokens)[0])  # warm-up
    direct, jobs = [direct_ms()], []
    for _ in range(PROC_JOBS):
        jobs.append(job())
        direct.append(direct_ms())
    off = [name for name, p in trainer.module.named_parameters()
           if p.device.type != torch.device(DEVICE).type]
    if off:
        fail("parameters off the card: %s" % off[:5])
    worker_ms = [j["ms_per_step"] for j in jobs]
    ms, direct_mean = np.mean(worker_ms), np.mean(direct)
    out = {"steps_per_job": n, "tasks_per_job": PROC_TASKS,
           "launches_per_step": want, "jobs": jobs,
           "worker_ms_per_step": worker_ms,
           "worker_tokens_per_s": B * T / ms * 1e3,
           "direct_ms_per_step": direct,
           "direct_tokens_per_s": B * T / direct_mean * 1e3,
           "task_loop_ms_per_step": ms - direct_mean,
           "task_loop_share": (ms - direct_mean) / ms,
           "trainer_timing": trainer.timing.summary()}
    print("process path, leg 1 (in process): %d jobs of %d tasks x %d steps "
          "of the flagship (batch %d x %d, remat) through the port's master "
          "and Worker on %s, launches per step B3 %d, B4 %d, B5 %d: ms per "
          "step %s (%.0f tokens/s), first steps %s s, losses %s; direct "
          "CollectiveTrainer steps before, between and after: %s ms (%.0f "
          "tokens/s); task loop %.2f ms per step (%.2f %%)" % (
              PROC_JOBS, PROC_TASKS, PROC_MINIBATCHES, B, T, DEVICE, *want,
              ", ".join("%.2f" % x for x in worker_ms),
              out["worker_tokens_per_s"],
              ", ".join("%.2f" % j["first_step_s"] for j in jobs),
              ", ".join("%.4f -> %.4f" % (j["losses"][0], j["losses"][-1])
                        for j in jobs),
              ", ".join("%.2f" % x for x in direct),
              out["direct_tokens_per_s"], out["task_loop_ms_per_step"],
              100 * out["task_loop_share"]))
    print("process path, leg 1: worker timing %s" % json.dumps(
        {k: v for k, v in jobs[0]["timing"].items() if "total_s" in v}))
    del trainer
    torch.cuda.empty_cache()
    return out


class _MasterProcess:
    """The master CLI as a subprocess; a thread stamps each log line with
    the host clock as it arrives.  ``what`` names the leg in failures."""

    def __init__(self, args, env, cwd, what="process path, leg 2"):
        self.what = what
        self.lines = []
        self._cond = threading.Condition()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.master.main"] + args,
            env=env, cwd=cwd, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self.proc.stderr:
            with self._cond:
                self.lines.append((time.perf_counter(), line))
                self._cond.notify_all()

    def wait_for(self, pattern, deadline, after=None, count=1):
        """(host time, match) of the ``count``-th log line matching
        ``pattern`` (that arrived at ``after`` or later); fails at
        ``deadline`` or when the master exits."""
        with self._cond:
            while True:
                seen = 0
                for t, line in self.lines:
                    if after is not None and t < after:
                        continue
                    m = re.search(pattern, line)
                    if m:
                        seen += 1
                        if seen == count:
                            return t, m
                if self.proc.poll() is not None or (
                        time.perf_counter() > deadline):
                    fail("%s: no %r in the master's log (master rc %s); "
                         "its tail:\n%s" % (self.what, pattern,
                                             self.proc.poll(), self.tail()))
                self._cond.wait(1.0)

    def tail(self, n=40):
        with self._cond:
            return "".join(line for _, line in self.lines[-n:])

    def children(self):
        try:
            with open("/proc/%d/task/%d/children" % (
                    self.proc.pid, self.proc.pid)) as f:
                return [int(p) for p in f.read().split()]
        except OSError:
            return []

    def worker_pid(self, worker_id):
        for pid in self.children():
            try:
                with open("/proc/%d/environ" % pid, "rb") as f:
                    env = f.read().split(b"\0")
            except OSError:
                continue
            if b"WORKER_ID=%d" % worker_id in env:
                return pid
        fail("%s: no worker %d among the master's children"
             % (self.what, worker_id))

    def stop(self):
        """Kill the master and every worker it left running."""
        if self.proc.poll() is None:
            for pid in self.children():
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
            self.proc.kill()
        self.proc.wait(timeout=60)
        self._thread.join(timeout=60)


def cli_leg(torch):
    """Leg 2: the master CLI with two worker processes on the card, a
    kill -9 of worker 0 after its first checkpoint; returns the leg's
    numbers."""
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ)
    env.pop("ELASTICDL_TORCH_DEVICE", None)     # the workers' default: cuda
    env["ELASTICDL_TORCH_BUILD_DIR"] = os.path.join(tmp.name, "build")
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    ckpt = os.path.join(tmp.name, "ckpt")
    args = ["--model_zoo", "transformer", "--model_params", CLI_PARAMS,
            "--data_origin", "synthetic_lm:%d:2048:32768" % CLI_RECORDS,
            "--batch_size", str(LM_TRAIN_BATCH),
            "--num_minibatches_per_task", str(PROC_MINIBATCHES),
            "--num_workers", "2", "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(CLI_CHECKPOINT_STEPS),
            "--log_loss_steps", "1"]
    job = _MasterProcess(args, env, tmp.name)
    deadline = job.t0 + CLI_TIMEOUT_S
    try:
        # Start-up in three parts: the interpreter and imports (to the
        # worker's first log line), then its master connection, model
        # spec, data and trainer on the card (to "training on"), then the
        # first step (the kernels built or loaded, the first step run).
        launched = {w: job.wait_for(r"launched worker %d\b" % w,
                                    deadline)[0] for w in (0, 1)}
        started = {w: job.wait_for(r"\[worker-%d\] .*worker starting" % w,
                                   deadline)[0] for w in (0, 1)}
        ready = {w: job.wait_for(r"worker %d training on" % w,
                                 deadline)[0] for w in (0, 1)}
        first = {w: job.wait_for(r"\[worker-%d\] .* step 1 loss" % w,
                                 deadline)[0] for w in (0, 1)}
        t_ckpt, m = job.wait_for(
            r"\[worker-0\] .*checkpoint version (\d+) written: (\d+) bytes "
            r"in ([\d.]+) s", deadline)
        ckpt_version, ckpt_bytes, ckpt_s = (
            int(m.group(1)), int(m.group(2)), float(m.group(3)))
        pid = job.worker_pid(0)
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        t_launch, _ = job.wait_for(r"launched worker 2\b", deadline)
        t_started, _ = job.wait_for(r"\[worker-2\] .*worker starting",
                                    deadline)
        t_ready, _ = job.wait_for(r"worker 2 training on", deadline)
        _, m = job.wait_for(r"\[worker-2\] .*restored checkpoint version "
                            r"(\d+)", deadline)
        restored = int(m.group(1))
        t_step, m = job.wait_for(
            r"\[worker-2\] .* step 1 loss [\d.]+ \(version (\d+)\)",
            deadline)
        version_after = int(m.group(1))
        try:
            rc = job.proc.wait(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail("process path, leg 2: the job did not finish within %d s;"
                 " its tail:\n%s" % (CLI_TIMEOUT_S, job.tail()))
        t_end = time.perf_counter()
    finally:
        job.stop()
        tmp.cleanup()
    log = "".join(line for _, line in job.lines)
    finished = re.search(r"job finished: .*'failed': \{0: 0, ", log)
    requeued = re.search(r"task \d+ failed \(worker 0 died\), retry 1/3",
                         log)
    on_card = sorted(set(re.findall(r"worker (\d+) training on (\S+)",
                                    log)))
    if rc != 0 or not finished or not requeued:
        fail("process path, leg 2: rc %s, job finished with no failed "
             "task: %s, the killed worker's task requeued: %s; tail:\n%s"
             % (rc, bool(finished), bool(requeued), job.tail()))
    if [w for w, _ in on_card] != ["0", "1", "2"] or any(
            not d.startswith(torch.device(DEVICE).type)
            for _, d in on_card):
        fail("process path, leg 2: workers ran on %s" % on_card)
    if not restored >= ckpt_version > 0 or version_after <= restored:
        fail("process path, leg 2: the replacement restored version %d "
             "(worker 0 wrote %d) and reached version %d after its first "
             "step" % (restored, ckpt_version, version_after))
    losses = [float(x) for x in re.findall(
        r"\[worker-\d\] .* step \d+ loss ([\d.eE+-]+)", log)]
    if not losses or not all(map(math.isfinite, losses)):
        fail("process path, leg 2: losses %s" % losses[:10])
    steps = len(losses)
    out = {"layers": CLI_LAYERS, "records": CLI_RECORDS, "steps": steps,
           "startup_s": {w: t - job.t0 for w, t in first.items()},
           "launched_s": {w: t - job.t0 for w, t in launched.items()},
           "started_s": {w: t - job.t0 for w, t in started.items()},
           "ready_s": {w: t - job.t0 for w, t in ready.items()},
           "checkpoint_version": ckpt_version,
           "checkpoint_bytes": ckpt_bytes, "checkpoint_write_s": ckpt_s,
           "kill_after_start_s": t_kill - job.t0,
           "relaunch_s": t_launch - t_kill,
           "recovery_s": t_step - t_kill,
           "replacement_started_s": t_started - t_kill,
           "replacement_ready_s": t_ready - t_kill,
           "restored_version": restored,
           "job_s": t_end - job.t0, "rc": rc,
           "first_loss": losses[0], "last_loss": losses[-1]}
    print("process path, leg 2 (CLI, 2 workers on the card, %d layers, "
          "cold kernel cache): after the master started, workers 0 and 1 "
          "were launched at %.1f s and %.1f s, logged their first line at "
          "%.1f s and %.1f s, were ready (model on the card) at %.1f s and "
          "%.1f s and ran their first steps at %.1f s and %.1f s; worker "
          "0's checkpoint (version %d, %d bytes) "
          "written in %.2f s; kill -9 at %.1f s; after it, replacement "
          "launched at %.2f s, first line at %.1f s, ready at %.1f s, "
          "restored version %d, first step at %.1f s; job finished exit 0 "
          "in %.1f s (%d steps logged), 0 failed tasks" % (
              CLI_LAYERS, out["launched_s"][0], out["launched_s"][1],
              out["started_s"][0], out["started_s"][1],
              out["ready_s"][0], out["ready_s"][1], out["startup_s"][0],
              out["startup_s"][1], ckpt_version, ckpt_bytes, ckpt_s,
              out["kill_after_start_s"], out["relaunch_s"],
              out["replacement_started_s"], out["replacement_ready_s"],
              restored, out["recovery_s"], out["job_s"], steps))
    return out


def process_phase(torch, fa):
    return {"in_process": process_leg(torch, fa), "cli": cli_leg(torch)}


# The managed elastic-collective path (phase 18).  Leg 1: ResNet-50 at
# full size (224x224, 1000 classes, float32, TF32 off) trained by two
# ranks spawned on the card, each a CollectiveTrainer at COLL_BATCH over
# a data mesh, their world formed through the port's
# MasterCoordinationService and initialize_from_rendezvous on gloo
# (host-staged: both ranks share the card).  Step-1 gradients are held
# against a single-process step at the global batch (2 x COLL_BATCH) with
# the dense-f32 plain GroupNorm, each leaf within the larger of
# COLL_GRAD_MIN and COLL_FLOOR_X x its noise floor in that single
# process; then the world re-forms 2 -> 1 -> 2 in place, a third process
# joining with other weights.
# A leaf's floor is the largest distance from the reference of the
# kernels at batch 64, the kernels at the ranks' batch of 32 and the plain
# path on those halves.  The kernels at 64 alone are not enough: B2 sums a
# batch of 32 in another order than one of 64, and on an H100 the last
# block's GroupNorm scale and bias (sums of 3,136 mixed-sign terms) land
# 2.3x and 5.3x past that floor.
# Leg 2: the master CLI with the collective strategy and two workers on
# the card (resnet50_cifar10, the ResNet-50 stages at full width on
# 32x32 synthetic_cifar10, COLL_CLI_BATCH a worker), worker 0 killed -9
# once both have stepped COLL_CLI_KILL_STEPS times in a world of 2.
COLL_IMAGE = 224
COLL_PARAMS = ("variant=resnet50;num_classes=1000;image_size=%d;"
               "learning_rate=%g" % (COLL_IMAGE, TRAIN_LR))
COLL_BATCH = 32
COLL_TIMED_STEPS = 3
# The 2-rank path adds the all-reduce's f32 sum of two halves to the
# kernels' noise at batch 32: twice the floor bounds it.
COLL_FLOOR_X = 2.0
# A leaf whose kernels-vs-plain floor is tiny is held at this instead.
COLL_GRAD_MIN = 1e-5
# The 2-rank loss is the single process's over the same 64 rows, summed
# as two halves: f32 rounding apart, ~1e-7 relative.
COLL_LOSS_RTOL = 1e-5
COLL_RANKS_TIMEOUT_S = 400
COLL_CLI_BATCH = 32
COLL_CLI_KILL_STEPS = 8
# Records enough that the survivor, alone, cannot finish them before the
# replacement joins, and few enough that the regrown world ends the job
# soon.  On an H100 (80GB HBM3, 700 W) the leg ran 22.3 steps/s (714
# records/s) at world 1 for the 25 s the replacement took to join, and
# 4.45 global steps/s (285 records/s) at world 2 (PERF.md §6): 24,576
# records leave ~25 s to the regrown world, and run out before the
# replacement joins only if it is 1.45x slower.
COLL_CLI_RECORDS = 24576
COLL_CLI_TIMEOUT_S = 300


def _state_digest(torch, trainer):
    """sha256 of the parameters, the SGD momentum and the version: equal
    digests are bit-equal states."""
    import hashlib

    h = hashlib.sha256()
    for p in trainer.module.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
        buf = trainer._optimizer.state.get(p, {}).get("momentum_buffer")
        h.update(b"-" if buf is None else buf.cpu().numpy().tobytes())
    h.update(str(trainer.version).encode())
    return h.hexdigest()


def _state_clone(trainer):
    return [t.detach().clone() for p in trainer.module.parameters()
            for t in [p] + [trainer._optimizer.state.get(p, {}).get(
                "momentum_buffer", p)]]


def _state_equal(torch, trainer, clone):
    return all(torch.equal(a, b) for a, b in zip(_state_clone(trainer),
                                                  clone))


def coll_rank(role, epochs, named, xs, ys):
    """One process of leg 1: ``role`` "rank0" (rank 0 of worlds 2, 1, 2),
    "rank1" (rank 1 of the first world) or "joiner" (rank 1 of the last,
    its own init from another seed).  Returns its readings."""
    import torch

    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.ops import group_norm as gn
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import transport
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()
    spec = load_model_spec("resnet", COLL_PARAMS)
    trainer = CollectiveTrainer(spec, batch_size=COLL_BATCH, device=DEVICE,
                                rng_seed=7 if role == "joiner" else 0)
    build = tdist.data_mesh_builder(DEVICE, COLL_RANKS_TIMEOUT_S)
    reduce_s = []
    real_reduce = transport.all_reduce_grads_

    def timed_reduce(params, group, scalars=()):
        # The host-staged all-reduce of one step, from the end of the
        # backward to the sums back on the card.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(params, group, scalars)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    transport.all_reduce_grads_ = timed_reduce

    def rebuild(rank, world, addr):
        trainer.snapshot_to_host()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.rebuild(build(rank, world, addr))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def step(i):
        loss, _ = trainer.train_minibatch(xs[i % len(xs)], ys[i % len(ys)])
        return float(loss)

    out = {}
    if role == "joiner":
        out["own"] = _state_digest(torch, trainer)
        out["join_s"] = rebuild(1, 2, epochs[2])
        out["adopted"] = _state_digest(torch, trainer)
        out["loss_joint"] = step(0)
        out["after"] = _state_digest(torch, trainer)
        tdist.reset_single_process()
        return out
    rank = 0 if role == "rank0" else 1
    if rank == 0:
        trainer.set_params(spec.params_from_jax(named))
    out["form_s"] = rebuild(rank, 2, epochs[0])
    out["start"] = _state_digest(torch, trainer)
    torch.cuda.synchronize()
    gn.LAUNCHES = gn.BWD_LAUNCHES = 0
    out["loss1"] = step(0)
    out["step1_launches"] = (gn.LAUNCHES, gn.BWD_LAUNCHES)
    if rank == 0:
        out["grads"] = {name: p.grad.detach().cpu() for name, p in
                        trainer.module.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["timed_losses"] = [step(i + 1) for i in range(COLL_TIMED_STEPS)]
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / COLL_TIMED_STEPS
    out["launches"] = (gn.LAUNCHES, gn.BWD_LAUNCHES)
    out["allreduce_ms"] = [s * 1e3 for s in reduce_s]
    out["world2"] = _state_digest(torch, trainer)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if role == "rank1":
        trainer.snapshot_to_host()
        tdist.reset_single_process()
        return out
    kept = _state_clone(trainer)
    out["shrink_s"] = rebuild(0, 1, epochs[1])
    out["kept_2_to_1"] = _state_equal(torch, trainer, kept)
    out["alone"] = (trainer.process_count, trainer.max_window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["loss_alone"] = step(1)
    out["alone_step_ms"] = (time.perf_counter() - t0) * 1e3
    kept = _state_clone(trainer)
    before_join = _state_digest(torch, trainer)
    out["grow_s"] = rebuild(0, 2, epochs[2])
    out["kept_1_to_2"] = _state_equal(torch, trainer, kept)
    out["before_join"] = before_join
    out["loss_joint"] = step(0)
    out["after"] = _state_digest(torch, trainer)
    tdist.reset_single_process()
    return out


def collective_leg(torch):
    """Leg 1: two ranks of ResNet-50 at 224 on the card against the
    single-process step, then 2 -> 1 -> 2 with a joiner."""
    from elasticdl_tpu_torch.models import resnet
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.ops import group_norm as gn
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import launch
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()
    spec = load_model_spec("resnet", COLL_PARAMS)
    B = COLL_BATCH
    rng = np.random.RandomState(18)
    shape = (2 * B, COLL_IMAGE, COLL_IMAGE, 3)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 1000, size=2 * B).astype(np.int32)
    more = [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, 1000, size=2 * B).astype(np.int32))
            for _ in range(COLL_TIMED_STEPS - 1)]

    def single(plain, split=False):
        """Step 1 in this process on the global batch, or (``split``) on
        each half at the ranks' batch from the same weights, the mean of
        their gradients."""
        rows = (slice(0, B), slice(B, None)) if split else (slice(None),)
        trainer = CollectiveTrainer(spec, batch_size=B if split else 2 * B,
                                    device=DEVICE)
        named = seeded_params(spec, trainer.module, seed=18)
        ctx = (plain_group_norm(resnet, gn) if plain
               else contextlib.nullcontext())
        losses, grads = [], {}
        with ctx:
            for part in rows:
                trainer.set_params(spec.params_from_jax(named))
                losses.append(float(trainer.train_minibatch(
                    x[part], y[part])[0]))
                for name, p in trainer.module.named_parameters():
                    g = p.grad.detach().cpu() / len(rows)
                    grads[name] = g + grads[name] if name in grads else g
        del trainer
        torch.cuda.empty_cache()
        return named, float(np.mean(losses)), grads

    named, loss_k, grads_k = single(plain=False)
    _, loss_p, grads_p = single(plain=True)
    # The reference's noise floor, leaf by leaf: the largest distance
    # from it of the kernels at the global batch, the kernels at the
    # ranks' batch (two halves: the B2 batch sums run in another order)
    # and the plain path itself on the two halves.
    floor = {n: 0.0 for n in grads_p}
    for grads in (grads_k, single(plain=False, split=True)[2],
                  single(plain=True, split=True)[2]):
        for n in floor:
            floor[n] = max(floor[n], norm_rel(grads[n], grads_p[n]))
    limit = {n: max(COLL_GRAD_MIN, COLL_FLOOR_X * f)
             for n, f in floor.items()}
    del grads_k, grads
    # One store per epoch, all up from the start: each epoch's master
    # would start its store at the commit (none is marked superseded).
    svcs = [tdist.MasterCoordinationService(reap_secs=COLL_RANKS_TIMEOUT_S)
            for _ in range(3)]
    epochs = [svc.start_epoch(n) for svc, n in zip(svcs, (2, 1, 2))]
    halves = {0: [x[:B]] + [b[0][:B] for b in more],
              1: [x[B:]] + [b[0][B:] for b in more]}
    labels = {0: [y[:B]] + [b[1][:B] for b in more],
              1: [y[B:]] + [b[1][B:] for b in more]}
    roles = {"rank0": (epochs, named, halves[0], labels[0]),
             "rank1": (epochs, None, halves[1], labels[1]),
             "joiner": (epochs, None, halves[1], labels[1])}
    t0 = time.perf_counter()
    got = dict(zip(roles, launch.run(
        [(coll_rank, (role,) + args) for role, args in roles.items()],
        timeout=COLL_RANKS_TIMEOUT_S)))
    ranks_s = time.perf_counter() - t0
    r0, r1, joiner = got["rank0"], got["rank1"], got["joiner"]
    errs = {n: norm_rel(r0["grads"][n], grads_p[n]) for n in grads_p}
    over = {n: (errs[n], limit[n]) for n in errs if not errs[n] <= limit[n]}
    if over:
        fail("collective path, leg 1: 2-rank step-1 gradients past their "
             "limits (norm-relative error, limit): %s" % dict(
                 sorted(over.items())[:8]))
    if abs(r0["loss1"] - loss_k) > COLL_LOSS_RTOL * abs(loss_k) or (
            r0["loss1"] != r1["loss1"]):
        fail("collective path, leg 1: step-1 loss %r / %r against the "
             "single process's %r" % (r0["loss1"], r1["loss1"], loss_k))
    want = (GN_PER_FORWARD, GN_PER_FORWARD)
    total = tuple(w * (1 + COLL_TIMED_STEPS) for w in want)
    for r in (r0, r1):
        if tuple(r["step1_launches"]) != want or tuple(
                r["launches"]) != total:
            fail("collective path, leg 1: a rank launched (B1, B2) %s in "
                 "step 1 and %s in all, want %s and %s" % (
                     r["step1_launches"], r["launches"], want, total))
    checks = {
        "rank 1 adopted rank 0's state": r0["start"] == r1["start"],
        "replicas equal after the steps": r0["world2"] == r1["world2"],
        "2 -> 1 kept state bitwise": r0["kept_2_to_1"],
        "alone at world 1": tuple(r0["alone"]) == (1, None),
        "1 -> 2 kept rank 0's state bitwise": r0["kept_1_to_2"],
        "the joiner started elsewhere": joiner["own"] != r0["before_join"],
        "the joiner adopted rank 0's state": (
            joiner["adopted"] == r0["before_join"]),
        "one joint step, one loss": (
            joiner["loss_joint"] == r0["loss_joint"]),
        "replicas equal after it": joiner["after"] == r0["after"],
        "finite losses": all(map(math.isfinite, [
            r0["loss1"], r0["loss_alone"], r0["loss_joint"]]
            + r0["timed_losses"])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("collective path, leg 1: %s" % bad)
    ar = r0["allreduce_ms"]
    out = {"batch_per_rank": B, "loss_single": loss_k, "loss_plain": loss_p,
           "loss_ranks": r0["loss1"], "grad_rel_err_max": max(errs.values()),
           "grad_worst_leaf": max(errs, key=lambda n: errs[n] / limit[n]),
           "floor_max": max(floor.values()),
           "err_over_limit_max": max(errs[n] / limit[n] for n in errs),
           "launches_per_step": want, "step_ms": r0["step_ms"],
           "step_ms_rank1": r1["step_ms"],
           "allreduce_ms": ar, "allreduce_ms_mean": float(np.mean(ar[1:])),
           "grad_mb": sum(g.numel() for g in grads_p.values()) * 4 / 1e6,
           "form_s": r0["form_s"], "shrink_s": r0["shrink_s"],
           "grow_s": r0["grow_s"], "join_s": joiner["join_s"],
           "alone_step_ms": r0["alone_step_ms"],
           "peak_gb": [r0["peak_gb"], r1["peak_gb"]], "ranks_s": ranks_s,
           "checks": sorted(checks)}
    print("collective path, leg 1 (ResNet-50 %dx%d f32, 2 ranks x batch "
          "%d on the card, gloo through the host): step-1 loss %.6f (single "
          "process at batch %d: %.6f), gradients within their limits (worst "
          "%.3g of its limit at %s; noise floor up to %.3g); B1/B2 "
          "%d/%d launches a step a rank; %.1f ms a step (rank 1 %.1f), "
          "all-reduce of %.1f MB %.1f ms a step (%s); world formed in %.2f s, "
          "2 -> 1 in %.2f s, a step alone %.1f ms, 1 -> 2 with a joiner in "
          "%.2f s (joiner %.2f s); %s; peak %.1f / %.1f GB" % (
              COLL_IMAGE, COLL_IMAGE, B, out["loss_ranks"], 2 * B, loss_k,
              out["err_over_limit_max"],
              out["grad_worst_leaf"], out["floor_max"], *want,
              out["step_ms"], out["step_ms_rank1"], out["grad_mb"],
              out["allreduce_ms_mean"], ", ".join("%.1f" % a for a in ar),
              out["form_s"], out["shrink_s"], out["alone_step_ms"],
              out["grow_s"], out["join_s"], ", ".join(sorted(checks)),
              *out["peak_gb"]))
    return out


def _rate(times):
    """Steps a second over step-log arrival times (None for < 2)."""
    if len(times) < 2 or times[-1] <= times[0]:
        return None
    return (len(times) - 1) / (times[-1] - times[0])


def collective_cli_leg(torch, zero1=False):
    """Leg 2: the master CLI's collective job with two workers on the card;
    kill -9 of worker 0 once both have stepped in a world of 2.  With
    ``zero1`` (phase 19) the job runs ``--zero1 true``: the workers log
    the ZeRO-1 placement at a world of 2, and the survivor restarts its
    moments at the shrink."""
    from elasticdl_tpu_torch.ops import build

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ)
    env.pop("ELASTICDL_TORCH_DEVICE", None)     # the workers' default: cuda
    # The libraries the build phase made: the workers load, never build.
    env["ELASTICDL_TORCH_BUILD_DIR"] = build.BUILD_DIR
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    args = ["--model_zoo", "resnet", "--model_params",
            "variant=resnet50_cifar10",
            "--data_origin", "synthetic_cifar10:%d" % COLL_CLI_RECORDS,
            "--batch_size", str(COLL_CLI_BATCH),
            "--num_minibatches_per_task", "4", "--num_workers", "2",
            "--distribution_strategy", "collective", "--log_loss_steps", "1"]
    what = "collective path, leg 2"
    if zero1:
        args += ["--zero1", "true"]
        what = "ZeRO-1 path, leg 2"
    job = _MasterProcess(args, env, tmp.name, what=what)
    deadline = job.t0 + COLL_CLI_TIMEOUT_S
    epoch = r"rendezvous epoch (\d+): world=\[%s\]"
    step = r"\[worker-%d\] .* step \d+ loss"
    try:
        t_w2, _ = job.wait_for(epoch % r"'worker-\d', 'worker-\d'", deadline)
        for w in (0, 1):
            job.wait_for(step % w, deadline, after=t_w2,
                         count=COLL_CLI_KILL_STEPS)
        os.kill(job.worker_pid(0), signal.SIGKILL)
        t_kill = time.perf_counter()
        t_fail, _ = job.wait_for(r"\[worker-1\] .*minibatch failed "
                                 r"\(attempt 1\)", deadline, after=t_kill)
        t_w1, _ = job.wait_for(epoch % r"'worker-1'", deadline, after=t_kill)
        t_s1, _ = job.wait_for(step % 1, deadline, after=t_w1)
        t_launch, _ = job.wait_for(r"launched worker 2\b", deadline,
                                   after=t_kill)
        t_w3, _ = job.wait_for(epoch % r"'worker-1', 'worker-2'", deadline,
                               after=t_w1)
        t_s3, _ = job.wait_for(step % 2, deadline, after=t_w3)
        try:
            rc = job.proc.wait(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail("%s: the job did not finish within %d s; its tail:\n%s"
                 % (what, COLL_CLI_TIMEOUT_S, job.tail()))
        t_end = time.perf_counter()
    finally:
        job.stop()
        tmp.cleanup()
    log = "".join(line for _, line in job.lines)
    finished = re.search(r"job finished: .*'failed': \{0: 0, ", log)
    if rc != 0 or not finished:
        fail("%s: rc %s, job finished with no failed task: %s; tail:\n%s"
             % (what, rc, bool(finished), job.tail()))
    on_card = sorted(set(re.findall(r"worker (\d+) training on (\S+)", log)))
    if [w for w, _ in on_card] != ["0", "1", "2"] or any(
            not d.startswith("cuda") for _, d in on_card):
        fail("%s: workers ran on %s" % (what, on_card))
    steps = {w: [t for t, line in job.lines
                 if re.search(step % w, line)] for w in (0, 1, 2)}
    launches = {}
    for w in (1, 2):
        m = re.search(r"\[worker-%d\] .*kernel launches: (\{.*\})" % w, log)
        if not m:
            fail("%s: worker %d logged no kernel launches" % (what, w))
        counts = json.loads(m.group(1))
        passes = counts["train_passes"]
        if not (passes >= len(steps[w]) > 0 and counts["group_norm_fwd"]
                == counts["group_norm_bwd"] == GN_PER_FORWARD * passes):
            fail("%s: worker %d launched %s over %d logged steps, want B1 "
                 "and B2 %d a pass" % (what, w, counts, len(steps[w]),
                                       GN_PER_FORWARD))
        launches[w] = counts
    zero1_lines = {}
    if zero1:
        placed = r"\[worker-%d\] .*zero1: optimizer state sharded 2 ways"
        reset = (r"\[worker-1\] .*zero1: .*re-initializing optimizer "
                 r"moments")
        zero1_lines = {
            "placement_world2": all(
                any(re.search(placed % w, line) for t, line in job.lines
                    if t < t_kill) for w in (0, 1)),
            "reset_at_shrink": any(re.search(reset, line) for t, line
                                   in job.lines if t_kill <= t <= t_s1),
            "placement_regrown": all(
                any(re.search(placed % w, line) for t, line in job.lines
                    if t >= t_w3) for w in (1, 2)),
        }
        bad = [k for k, ok in zero1_lines.items() if not ok]
        if bad:
            fail("%s: the workers' logs lack %s; tail:\n%s"
                 % (what, bad, job.tail()))
    world2 = [t for t in steps[1] if t_w2 <= t < t_kill]
    world1 = [t for t in steps[1] if t_s1 <= t < t_w3]
    regrown = [t for t in steps[2] if t >= t_s3]
    out = {"batch": COLL_CLI_BATCH, "records": COLL_CLI_RECORDS,
           "job_s": t_end - job.t0, "world2_at_s": t_w2 - job.t0,
           "kill_at_s": t_kill - job.t0,
           "kill_to_failure_s": t_fail - t_kill,
           "kill_to_world1_epoch_s": t_w1 - t_kill,
           "kill_to_world1_step_s": t_s1 - t_kill,
           "kill_to_relaunch_s": t_launch - t_kill,
           "kill_to_world2_epoch_s": t_w3 - t_kill,
           "kill_to_world2_step_s": t_s3 - t_kill,
           "steps_per_s_world2": _rate(world2),
           "steps_per_s_world1": _rate(world1),
           "steps_per_s_world2_again": _rate(regrown),
           "steps": {w: len(s) for w, s in steps.items()},
           "launches": launches, "rc": rc, "zero1_logs": zero1_lines}
    print("%s (master CLI, collective, 2 workers on the card, "
          "resnet50_cifar10 batch %d a worker, %d records): world of 2 at "
          "%.1f s, kill -9 of worker 0 at %.1f s; after it the survivor's "
          "in-band failure at %.2f s, an epoch of world 1 at %.2f s and its "
          "first step there at %.2f s, the relaunch at %.2f s, an epoch of "
          "world 2 at %.2f s and its first step at %.2f s; steps/s at world "
          "2 %s, world 1 %s, world 2 again %s; worker launches %s; job "
          "finished exit 0 in %.1f s, 0 failed tasks" % (
              what, COLL_CLI_BATCH, COLL_CLI_RECORDS, out["world2_at_s"],
              out["kill_at_s"], out["kill_to_failure_s"],
              out["kill_to_world1_epoch_s"], out["kill_to_world1_step_s"],
              out["kill_to_relaunch_s"], out["kill_to_world2_epoch_s"],
              out["kill_to_world2_step_s"], out["steps_per_s_world2"],
              out["steps_per_s_world1"], out["steps_per_s_world2_again"],
              json.dumps(launches), out["job_s"]))
    return out


def collective_phase(torch):
    return {"ranks": collective_leg(torch), "cli": collective_cli_leg(torch)}


# ZeRO-1 on the collective path (phase 19).  Leg 1: ResNet-50 at full size
# (224x224, 1000 classes, float32, TF32 off) trained by two ranks on the
# card at COLL_BATCH each, a world formed as phase 18's, ZERO_STEPS steps
# with zero1=True and the same steps from the same weights with
# zero1=False over a second mesh of the same world, on cuDNN's
# deterministic algorithms: losses, parameters and the whole optimizer
# state (the shards gathered) bit for bit equal;
# then the world re-formed 2 -> 3 with a joiner (every old shard present:
# the momentum kept bit for bit, equal to the zero1=False leg's at the
# same version, the no-churn reference) and 3 -> 2 with a leaver (a shard
# gone: the momentum restarts, zero1_moment_resets 1, parameters kept).
# Leg 2: phase 18's CLI leg with --zero1 true.
# cuDNN's default algorithms are not bitwise reproducible from run to run
# (on an H100, 80GB HBM3, 700 W, two zero1=False legs from the same
# weights on the same batches parted at the third step's loss), so the
# gated legs run with torch.backends.cudnn.deterministic = True and
# benchmark = False, and two zero1=False legs under the defaults first
# record whether the defaults reproduce (printed, not gated).
ZERO_STEPS = COLL_TIMED_STEPS + 1      # a first step, then the timed ones


def _fingerprint(torch, tensors):
    """Each tensor's bits, summed on its device into two position-weighted
    sums modulo 2**64: two tensors that differ in one element never share
    them, and in several almost never."""
    mod, sums = 2 ** 64, []
    for t in tensors:
        flat = t.detach().contiguous().reshape(-1)
        bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        s1 = s2 = 0
        for lo in range(0, bits.numel(), 1 << 24):
            b = bits[lo:lo + (1 << 24)].to(torch.int64)
            i = torch.arange(lo, lo + b.numel(), device=b.device,
                             dtype=torch.int64)
            s1 = (s1 + int((b * (2 * i + 1)).sum())) % mod
            s2 = (s2 + int((b * (i * 6364136223846793005 + 1442695040888963407
                                 | 1)).sum())) % mod
        sums.append((s1, s2))
    return sums


def _state_print(torch, trainer):
    """(fingerprint of the parameters and buffers, fingerprint of the
    whole optimizer state with its counts, its largest |slot|), compared
    with ``==``; the state is gathered from the ranks' shards under
    ZeRO-1, so every member of the world calls it."""
    state = trainer._whole_state()
    names = sorted(state)
    slots = [state[k] for k in names if isinstance(state[k], torch.Tensor)]
    counts = [(k, int(np.asarray(state[k]))) for k in names
              if not isinstance(state[k], torch.Tensor)]
    params = trainer.module.state_dict()
    biggest = max(float(t.abs().max()) for t in slots if t.ndim)
    return (_fingerprint(torch, [params[k] for k in sorted(params)]),
            (_fingerprint(torch, slots), counts), biggest)


def zero_rank(role, epochs, named):
    """One process of phase 19's leg 1: ``role`` "rank0" (rank 0 of the
    worlds 2, 3, 2), "rank1" (rank 1 of the first two) or "joiner" (rank 2
    of the world of 3, rank 1 of the last; its own init from another
    seed).  Returns its readings."""
    import datetime

    import torch

    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.ops import group_norm as gn
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import transport
    from elasticdl_tpu_torch.parallel.mesh import data_mesh
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()
    spec = load_model_spec("resnet", COLL_PARAMS)
    build = tdist.data_mesh_builder(DEVICE, COLL_RANKS_TIMEOUT_S)
    rank = {"rank0": 0, "rank1": 1, "joiner": 2}[role]
    rng = np.random.RandomState(1900 + rank)
    shape = (COLL_BATCH, COLL_IMAGE, COLL_IMAGE, 3)
    data = [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, 1000, size=COLL_BATCH).astype(np.int32))
            for _ in range(ZERO_STEPS + 2)]
    gather_s = []
    timed = {"on": False}
    real_gather = transport.all_gather_flat_

    def timed_gather(outs, shards, group):
        # The host-staged all-gather of a step's fresh shards, from the
        # shard update's end to the parameters' bytes back on the card.
        if not timed["on"]:
            return real_gather(outs, shards, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_gather(outs, shards, group)
        torch.cuda.synchronize()
        gather_s.append(time.perf_counter() - t0)

    transport.all_gather_flat_ = timed_gather

    def trainer(zero1):
        t = CollectiveTrainer(spec, batch_size=COLL_BATCH, device=DEVICE,
                              zero1=zero1, rng_seed=7 if rank == 2 else 0)
        if rank == 0:
            t.set_params(spec.params_from_jax(named))
        return t

    def steps(t, batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(t.train_minibatch(x, y)[0]) for x, y in batches]
        return losses, (time.perf_counter() - t0) * 1e3 / len(batches)

    def reform(t, world_rank, world, addr):
        t.snapshot_to_host()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.rebuild(build(world_rank, world, addr))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def counters(t):
        return {k: v for k, v in t.timing.counters().items()
                if k.startswith("zero1_")}

    def replicated():
        """A zero1=False trainer over a second mesh of the world."""
        r = trainer(False)
        r.rebuild(data_mesh(backend=tdist.BACKEND, device=DEVICE,
                            timeout=datetime.timedelta(
                                seconds=COLL_RANKS_TIMEOUT_S)))
        return r

    def leg(t, time_gathers=False):
        """ZERO_STEPS steps: (losses, ms a step after the first, state);
        ``time_gathers`` times each step's parameter all-gather."""
        timed["on"] = time_gathers
        first, _ = steps(t, data[:1])
        rest, ms = steps(t, data[1:ZERO_STEPS])
        timed["on"] = False
        return first + rest, ms, _state_print(torch, t)

    out = {}
    z = trainer(True)
    if rank < 2:
        out["form_s"] = reform(z, rank, 2, epochs[0])
        out["default_legs"] = [leg(replicated()) for _ in range(2)]
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        r = replicated()
        out["reports"] = (r.zero1_report(), z.zero1_report())
        out["flat_param_bytes"] = z._zero.flat_param_bytes()
        out["off_losses"], out["off_step_ms"], out["off_state"] = leg(r)
        torch.cuda.synchronize()
        gn.LAUNCHES = gn.BWD_LAUNCHES = 0
        out["on_losses"], out["on_step_ms"], out["on_state"] = leg(z, True)
        out["launches"] = (gn.LAUNCHES, gn.BWD_LAUNCHES)
        out["all_gather_ms"] = [t * 1e3 for t in gather_s]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del r
        torch.cuda.empty_cache()
    # 2 -> 3: the joiner brings no shard; the old two bring both.
    out["grow_s"] = reform(z, rank, 3, epochs[1])
    out["state_3"] = _state_print(torch, z)
    out["counters_3"] = counters(z)
    out["report_3"] = z.zero1_report()
    out["loss_3"] = steps(z, data[ZERO_STEPS:ZERO_STEPS + 1])[0][0]
    out["stepped_3"] = _state_print(torch, z)
    # 3 -> 2: rank 1 leaves with its shard.
    if rank == 1:
        z.snapshot_to_host()
        tdist.reset_single_process()
        return out
    out["shrink_s"] = reform(z, {0: 0, 2: 1}[rank], 2, epochs[2])
    out["state_2"] = _state_print(torch, z)
    out["counters_2"] = counters(z)
    out["loss_2"] = steps(z, data[ZERO_STEPS + 1:])[0][0]
    tdist.reset_single_process()
    return out


def zero1_leg(torch):
    """Leg 1 of phase 19 (see ZERO_STEPS): ZeRO-1 on against off, bit for
    bit, then 2 -> 3 -> 2."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import launch
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    spec = load_model_spec("resnet", COLL_PARAMS)
    named = seeded_params(spec, CollectiveTrainer(
        spec, batch_size=COLL_BATCH, device=DEVICE).module, seed=19)
    torch.cuda.empty_cache()
    svcs = [tdist.MasterCoordinationService(reap_secs=COLL_RANKS_TIMEOUT_S)
            for _ in range(3)]
    epochs = [svc.start_epoch(n) for svc, n in zip(svcs, (2, 3, 2))]
    roles = ("rank0", "rank1", "joiner")
    t0 = time.perf_counter()
    r0, r1, joiner = launch.run(
        [(zero_rank, (role, epochs, named if role == "rank0" else None))
         for role in roles], timeout=COLL_RANKS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    want = tuple(GN_PER_FORWARD * ZERO_STEPS for _ in range(2))
    off_report, on_report = r0["reports"]
    checks = {
        "ZeRO-1 losses bitwise those of zero1=False": all(
            r["on_losses"] == r["off_losses"] for r in (r0, r1)),
        "one global loss": r0["on_losses"] == r1["on_losses"],
        "parameters bitwise": r0["on_state"][0] == r0["off_state"][0]
        == r1["on_state"][0],
        "optimizer state bitwise": r0["on_state"][1] == r0["off_state"][1]
        == r1["on_state"][1],
        "B1/B2 %d a step a rank" % GN_PER_FORWARD: all(
            tuple(r["launches"]) == want for r in (r0, r1)),
        "half the optimizer state a rank": on_report["mode"] == "zero1"
        and off_report["mode"] == "replicated"
        and 2 * on_report["per_device_bytes"]
        <= 1.01 * off_report["per_device_bytes"],
        "2 -> 3 kept the state bitwise": all(
            r["state_3"][1] == r0["on_state"][1] for r in (r0, r1, joiner)),
        "2 -> 3 restarted nothing": all(
            r["counters_3"].get("zero1_moment_resets", 0) == 0
            for r in (r0, r1, joiner)),
        "the joiner adopted rank 0's parameters": joiner["state_3"][0]
        == r0["on_state"][0],
        "one step at 3, one state": joiner["stepped_3"] == r0["stepped_3"]
        == r1["stepped_3"] and joiner["loss_3"] == r0["loss_3"],
        "3 -> 2 restarted the moments": all(
            r["state_2"][2] == 0.0
            and r["counters_2"].get("zero1_moment_resets") == 1
            for r in (r0, joiner)),
        "3 -> 2 kept the parameters": joiner["state_2"][0]
        == r0["state_2"][0] == r0["stepped_3"][0],
        "finite losses": all(map(math.isfinite, r0["on_losses"] + [
            r0["loss_3"], r0["loss_2"], joiner["loss_2"]])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("ZeRO-1 path, leg 1: %s (losses on %s, off %s)" % (
            bad, r0["on_losses"], r0["off_losses"]))
    ag = r0["all_gather_ms"]
    (d1_losses, d1_ms, d1_state), (d2_losses, d2_ms, d2_state) = r0[
        "default_legs"]
    out = {"batch_per_rank": COLL_BATCH, "steps": ZERO_STEPS,
           "losses": r0["on_losses"],
           "default_cudnn_reproduces": d1_losses == d2_losses
           and d1_state[:2] == d2_state[:2],
           "default_cudnn_losses": [d1_losses, d2_losses],
           "default_cudnn_step_ms": [d1_ms, d2_ms],
           "report_off": off_report, "report_on": on_report,
           "report_world3": r0["report_3"],
           "step_ms_on": r0["on_step_ms"], "step_ms_off": r0["off_step_ms"],
           "step_ms_on_rank1": r1["on_step_ms"],
           "step_ms_off_rank1": r1["off_step_ms"],
           "all_gather_ms": ag, "all_gather_ms_mean": float(np.mean(ag[1:])),
           "all_gather_mb": r0["flat_param_bytes"] / 1e6,
           "launches_per_step": tuple(n // ZERO_STEPS
                                      for n in r0["launches"]),
           "form_s": r0["form_s"], "grow_s": r0["grow_s"],
           "join_s": joiner["grow_s"], "shrink_s": r0["shrink_s"],
           "reshard_bytes_3": r0["counters_3"].get("zero1_reshard_bytes"),
           "peak_gb": [r0["peak_gb"], r1["peak_gb"]], "ranks_s": ranks_s,
           "checks": sorted(checks)}
    print("ZeRO-1 path, leg 1 (ResNet-50 %dx%d f32, 2 ranks x batch %d on "
          "the card, gloo through the host, %d steps): two zero1=False legs "
          "under cuDNN's default algorithms %s (losses %s; %.1f, %.1f ms a "
          "step); under its deterministic ones zero1 on = off bit "
          "for bit (losses %s); optimizer state a rank %.1f MB zero1 (%d "
          "shards) vs %.1f MB replicated; %.1f ms a step on (rank 1 %.1f) "
          "vs %.1f off (rank 1 %.1f), the all-gather of %.1f MB %.1f ms a "
          "step (%s); B1/B2 %d/%d launches a step a rank; world formed in "
          "%.2f s, 2 -> 3 in %.2f s (joiner %.2f s, state bitwise), 3 -> 2 "
          "in %.2f s (moments restarted); %s; peak %.1f / %.1f GB" % (
              COLL_IMAGE, COLL_IMAGE, COLL_BATCH, ZERO_STEPS,
              "reproduce bit for bit" if out["default_cudnn_reproduces"]
              else "differ", out["default_cudnn_losses"], d1_ms, d2_ms,
              out["losses"],
              on_report["per_device_bytes"] / 1e6, on_report["num_shards"],
              off_report["per_device_bytes"] / 1e6, out["step_ms_on"],
              out["step_ms_on_rank1"], out["step_ms_off"],
              out["step_ms_off_rank1"], out["all_gather_mb"],
              out["all_gather_ms_mean"], ", ".join("%.1f" % a for a in ag),
              *out["launches_per_step"], out["form_s"], out["grow_s"],
              out["join_s"], out["shrink_s"], ", ".join(sorted(checks)),
              *out["peak_gb"]))
    return out


def zero1_phase(torch):
    return {"ranks": zero1_leg(torch),
            "cli": collective_cli_leg(torch, zero1=True)}


# The collective LM (phase 20).  Leg 1: the flagship LM at full width and
# depth (LM_PARAMS, remat) trained by two ranks spawned on the card, each a
# CollectiveTrainer at half the global batch over a data mesh, the world
# formed as phase 18's (MasterCoordinationService and
# initialize_from_rendezvous on gloo, host-staged transfers): step-1 loss
# and gradients in float32 (TF32 off) at CLM_GRAD_BATCH a rank and in bf16
# at CLM_BATCH a rank against the single process's at the global batch
# (phase 11's references, ``sp1_reference``: each leaf within its limit of
# the dense f32 softmax path's gradients, the loss within CLM_LOSS_RTOL of
# the kernel path's), B3/B4/B5 48/24/24 launches a step a rank,
# CLM_ZERO_STEPS timed steps; then 2 -> 1 -> 2 in place, a third process
# joining with other weights (rank 0 broadcasts the parameters and the
# AdamW moments, 5.2 GB, through the host); then, in the world of rank 0
# and the joiner, CLM_ZERO_STEPS steps with zero1=False and the same with
# zero1=True, each from seed 0 (the zero1=False leg against the bf16
# leg's steps, in another world of other processes, shows whether a step
# reproduces bit for bit on the card).  States are compared by
# ``_state_print`` on the card.  The ranks' groups wait
# CLM_RANKS_TIMEOUT_S for a peer (the joiner waits for rank 0's first
# legs).  Leg 2: the port's wrap-your-own-loop example
# (models/mnist_torch.py) on the card against a port master in this
# process.  The LoRA CLI job with a kill -9 is not driven here (ROADMAP
# A4c): the script's time limit holds no fourth CLI job.
CLM_BATCH = LM_TRAIN_BATCH // 2
CLM_GRAD_BATCH = LM_GRAD_BATCH // 2
# Steps a leg, each timed: the second reads the moments of the first.
CLM_ZERO_STEPS = 2
CLM_RANKS_TIMEOUT_S = 900
# The ranks' step-1 loss against the single process's at the global batch:
# the same sequences through the same kernels, the matmuls' rows split in
# two.  SP_LOSS_RTOL bounds the same kind of gap (one loss computed along
# two paths of bf16 rounding on the same parameters).
CLM_LOSS_RTOL = SP_LOSS_RTOL
LM_LAYERS = int(re.search(r"num_layers=(\d+)", LM_PARAMS).group(1))
MNIST_TORCH_RECORDS = 512
MNIST_TORCH_BATCH = 32


def clm_rank(role, epochs, legs):
    """One process of phase 20's leg 1: ``role`` "rank0" (rank 0 of the
    worlds 2, 1, 2), "rank1" (rank 1 of the first) or "joiner" (rank 1 of
    the last, its own init from another seed).  ``legs``: the f32 and
    bf16 references (tokens, model params, rank 0's gradients file and
    limits).  Returns its readings."""
    import datetime

    import torch

    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import transport
    from elasticdl_tpu_torch.parallel.mesh import data_mesh
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()
    build = tdist.data_mesh_builder(DEVICE, CLM_RANKS_TIMEOUT_S)
    rank = 0 if role == "rank0" else 1
    times = {"reduce": [], "gather": []}
    real = {"reduce": transport.all_reduce_grads_,
            "gather": transport.all_gather_flat_}

    def timing(kind):
        def wrapped(*args):
            # A step's host-staged collective, synchronised on both ends.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real[kind](*args)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
        return wrapped

    transport.all_reduce_grads_ = timing("reduce")
    transport.all_gather_flat_ = timing("gather")
    specs = {k: load_model_spec("transformer", leg["params"])
             for k, leg in legs.items()}

    def rows(name, batch):
        toks = legs[name]["tokens"][rank * batch:(rank + 1) * batch]
        return toks, toks

    def step(trainer, batch):
        return float(trainer.train_minibatch(*batch)[0])

    def timed_steps(trainer, n):
        """n steps on this rank's bf16 rows: (losses, ms of each)."""
        losses, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(trainer, rows("bf16", CLM_BATCH)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    def fingerprint(trainer):
        return _state_print(torch, trainer) + (trainer.version,)

    def mesh():
        return data_mesh(backend=tdist.BACKEND, device=DEVICE,
                         timeout=datetime.timedelta(
                             seconds=CLM_RANKS_TIMEOUT_S))

    def reform(trainer, world_rank, world, addr):
        trainer.snapshot_to_host()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.rebuild(build(world_rank, world, addr))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def check_grads(name, trainer):
        """Rank 0's step-1 gradients against the reference's: {leaf:
        norm-relative error}."""
        ref = torch.load(legs[name]["grads_path"])
        errs = {}
        for n, p in trainer.module.named_parameters():
            if p.grad is None or not bool(p.grad.isfinite().all()):
                raise RuntimeError("%s: the gradient of %s is missing or "
                                   "not finite" % (name, n))
            errs[n] = norm_rel(p.grad, ref[n].to(p.device))
        return errs

    out = {}
    if role == "joiner":
        trainer = CollectiveTrainer(specs["bf16"], batch_size=CLM_BATCH,
                                    device=DEVICE, rng_seed=7)
        out["own"] = fingerprint(trainer)
        out["join_s"] = reform(trainer, 1, 2, epochs[2])
        out["adopted"] = fingerprint(trainer)
        out["loss_joint"] = step(trainer, rows("bf16", CLM_BATCH))
        out["after"] = fingerprint(trainer)
    else:
        # f32 (TF32 off), one sequence a rank: step 1 and its launches.
        trainer = CollectiveTrainer(specs["f32"], batch_size=CLM_GRAD_BATCH,
                                    device=DEVICE)
        out["form_s"] = reform(trainer, rank, 2, epochs[0])
        zero_flash_counts(fa)
        out["f32"] = {"loss": step(trainer, rows("f32", CLM_GRAD_BATCH))}
        torch.cuda.synchronize()
        out["f32"]["launches"] = flash_counts(fa)
        if rank == 0:
            out["f32"]["errs"] = check_grads("f32", trainer)
        del trainer
        torch.cuda.empty_cache()
        # bf16, the main path: CLM_ZERO_STEPS timed steps, the launches of
        # the first counted.
        trainer = CollectiveTrainer(specs["bf16"], batch_size=CLM_BATCH,
                                    device=DEVICE, mesh=mesh())
        out["start"] = fingerprint(trainer)
        torch.cuda.reset_peak_memory_stats()
        times["reduce"].clear()
        zero_flash_counts(fa)
        losses, ms = timed_steps(trainer, 1)
        out["bf16"] = {"loss": losses[0], "launches": flash_counts(fa)}
        if rank == 0:
            out["bf16"]["errs"] = check_grads("bf16", trainer)
        more, more_ms = timed_steps(trainer, CLM_ZERO_STEPS - 1)
        out["losses"], out["step_ms"] = losses + more, ms + more_ms
        out["allreduce_ms"] = [s * 1e3 for s in times["reduce"]]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["world2"] = fingerprint(trainer)
        if role == "rank1":
            trainer.snapshot_to_host()
            tdist.reset_single_process()
            return out
        out["shrink_s"] = reform(trainer, 0, 1, epochs[1])
        out["shrunk"] = fingerprint(trainer)
        out["alone"] = (trainer.process_count, trainer.max_window)
        _, (out["alone_step_ms"],) = timed_steps(trainer, 1)
        out["before_join"] = fingerprint(trainer)
        out["grow_s"] = reform(trainer, 0, 2, epochs[2])
        out["grown"] = fingerprint(trainer)
        out["loss_joint"] = step(trainer, rows("bf16", CLM_BATCH))
        out["after"] = fingerprint(trainer)
    del trainer
    torch.cuda.empty_cache()

    # ZeRO-1 off and on in the world of rank 0 and the joiner, each leg a
    # fresh trainer from seed 0 over a mesh of its own.
    def zero_leg(zero1):
        trainer = CollectiveTrainer(specs["bf16"], batch_size=CLM_BATCH,
                                    device=DEVICE, zero1=zero1, mesh=mesh())
        times["gather"].clear()
        losses, ms = timed_steps(trainer, CLM_ZERO_STEPS)
        leg = {"losses": losses, "step_ms": ms,
               "report": trainer.zero1_report(),
               "all_gather_ms": [s * 1e3 for s in times["gather"]],
               "state": fingerprint(trainer)}
        del trainer
        torch.cuda.empty_cache()
        return leg

    out["off"] = zero_leg(False)
    out["on"] = zero_leg(True)
    out["zero_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    tdist.reset_single_process()
    return out


def clm_ranks_leg(torch, lm_refs):
    """Leg 1 of phase 20 (see CLM_BATCH)."""
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import launch

    tmp = tempfile.TemporaryDirectory()
    try:
        legs = {}
        for name in ("f32", "bf16"):
            ref = lm_refs[name]
            path = os.path.join(tmp.name, name + ".pt")
            torch.save(ref["grads"], path)
            legs[name] = {"params": ref["params"], "tokens": ref["tokens"],
                          "grads_path": path}
        svcs = [tdist.MasterCoordinationService(
            reap_secs=CLM_RANKS_TIMEOUT_S) for _ in range(3)]
        epochs = [svc.start_epoch(n) for svc, n in zip(svcs, (2, 1, 2))]
        roles = ("rank0", "rank1", "joiner")
        t0 = time.perf_counter()
        try:
            r0, r1, joiner = launch.run(
                [(clm_rank, (role, epochs, legs)) for role in roles],
                timeout=CLM_RANKS_TIMEOUT_S)
        except RuntimeError as e:
            fail("collective LM, leg 1: %s" % e)
        ranks_s = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    want = (2 * LM_LAYERS, LM_LAYERS, LM_LAYERS)
    readings = {}
    for name in ("f32", "bf16"):
        ref, got = lm_refs[name], r0[name]
        errs = got["errs"]
        over = {n: (errs[n], ref["limit"][n]) for n in errs
                if not errs[n] <= ref["limit"][n]}
        if over:
            fail("collective LM, leg 1, %s: 2-rank step-1 gradients past "
                 "their limits (norm-relative error, limit): %s"
                 % (name, dict(sorted(over.items())[:8])))
        gap = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        if not gap <= CLM_LOSS_RTOL or got["loss"] != r1[name]["loss"]:
            fail("collective LM, leg 1, %s: step-1 loss %r / %r against "
                 "the single process's %r (limit %g relative)" % (
                     name, got["loss"], r1[name]["loss"], ref["loss"],
                     CLM_LOSS_RTOL))
        for r in (r0, r1):
            if tuple(r[name]["launches"]) != want:
                fail("collective LM, leg 1, %s: a rank launched (B3, B4, "
                     "B5) %s in step 1, want %s" % (
                         name, r[name]["launches"], want))
        worst = max(errs, key=lambda n: errs[n] / ref["limit"][n])
        readings[name] = {"loss_ranks": got["loss"],
                          "loss_single": ref["loss"], "loss_rel_gap": gap,
                          "worst_leaf": worst,
                          "err_over_limit_max": errs[worst]
                          / ref["limit"][worst],
                          "grad_rel_err_max": max(errs.values())}
    on, off = r0["on"], r0["off"]
    checks = {
        "rank 1 adopted rank 0's state": r0["start"] == r1["start"],
        "replicas equal after the steps": r0["world2"] == r1["world2"]
        and r0["losses"] == r1["losses"],
        "2 -> 1 kept parameters, moments and version bitwise": (
            r0["shrunk"] == r0["world2"]),
        "alone at world 1": tuple(r0["alone"]) == (1, None),
        "1 -> 2 kept rank 0's state bitwise": (
            r0["grown"] == r0["before_join"]),
        "the joiner started elsewhere": joiner["own"] != r0["before_join"],
        "the joiner adopted rank 0's parameters, moments and version": (
            joiner["adopted"] == r0["before_join"]),
        "one joint step, one loss": (
            joiner["loss_joint"] == r0["loss_joint"]),
        "replicas equal after it": joiner["after"] == r0["after"],
        "a zero1=False leg reproduces the bf16 leg bit for bit": (
            off["losses"] == r0["losses"] and off["state"] == r0["world2"]
            == joiner["off"]["state"]),
        "ZeRO-1 on = off bit for bit (losses, parameters, AdamW state)": (
            on["losses"] == off["losses"] and on["state"] == off["state"]
            == joiner["on"]["state"]),
        "one world, one loss": on["losses"] == joiner["on"]["losses"],
        "half the AdamW state a rank": on["report"]["mode"] == "zero1"
        and off["report"]["mode"] == "replicated"
        and 2 * on["report"]["per_device_bytes"]
        <= 1.01 * off["report"]["per_device_bytes"],
        "finite losses": all(map(math.isfinite, [
            r0["loss_joint"]] + r0["losses"] + on["losses"])),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("collective LM, leg 1: %s (losses of the bf16 leg %s, ZeRO-1 "
             "on %s, off %s)" % (bad, r0["losses"], on["losses"],
                                 off["losses"]))
    ar = r0["allreduce_ms"]
    ag = on["all_gather_ms"]
    step_ms = float(np.mean(r0["step_ms"]))
    tokens = 2 * CLM_BATCH * lm_refs["bf16"]["tokens"].shape[1]
    out = {"batch_per_rank": CLM_BATCH, "f32": readings["f32"],
           "bf16": readings["bf16"],
           "launches_per_step": [r0["bf16"]["launches"],
                                 r1["bf16"]["launches"]],
           "losses": r0["losses"], "step_ms": r0["step_ms"],
           "step_ms_rank1": r1["step_ms"], "step_ms_mean": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "allreduce_ms": ar, "allreduce_ms_mean": float(np.mean(ar)),
           "peak_gb": [r0["peak_gb"], r1["peak_gb"]],
           "form_s": r0["form_s"], "shrink_s": r0["shrink_s"],
           "alone_step_ms": r0["alone_step_ms"], "grow_s": r0["grow_s"],
           "join_s": joiner["join_s"],
           "zero1": {"losses": on["losses"], "step_ms_on": on["step_ms"],
                     "step_ms_off": off["step_ms"],
                     "step_ms_on_joiner": joiner["on"]["step_ms"],
                     "all_gather_ms": ag,
                     "all_gather_ms_mean": float(np.mean(ag)),
                     "report_on": on["report"], "report_off": off["report"],
                     "peak_gb": [r0["zero_peak_gb"],
                                 joiner["zero_peak_gb"]]},
           "ranks_s": ranks_s, "checks": sorted(checks)}
    z = out["zero1"]

    def each(ms):
        return ", ".join("%.1f" % t for t in ms)

    print("collective LM, leg 1 (the flagship, %d layers, 2 ranks on the "
          "card, gloo through the host): step-1 loss f32 batch %d a rank "
          "%.6f (single process at %d: %.6f, gap %.3g), bf16 batch %d a rank "
          "%.6f (single process at %d: %.6f, gap %.3g; limit %g); gradients "
          "within their limits (worst %.3g of its limit at %s in f32, %.3g "
          "at %s in bf16); B3/B4/B5 launches in a step, rank 0 %s, rank 1 "
          "%s; bf16 ms a step %s (rank 1 %s), %.0f tokens/s, the all-reduce "
          "of %.1f MB %.1f ms a step (%s); peak %.1f / %.1f GB; world formed "
          "in %.2f s, 2 -> 1 in %.2f s, a step alone %.1f ms, 1 -> 2 with a "
          "joiner in %.2f s (joiner %.2f s)" % (
              LM_LAYERS, CLM_GRAD_BATCH, readings["f32"]["loss_ranks"],
              2 * CLM_GRAD_BATCH, readings["f32"]["loss_single"],
              readings["f32"]["loss_rel_gap"], CLM_BATCH,
              readings["bf16"]["loss_ranks"], 2 * CLM_BATCH,
              readings["bf16"]["loss_single"],
              readings["bf16"]["loss_rel_gap"], CLM_LOSS_RTOL,
              readings["f32"]["err_over_limit_max"],
              readings["f32"]["worst_leaf"],
              readings["bf16"]["err_over_limit_max"],
              readings["bf16"]["worst_leaf"], *out["launches_per_step"],
              each(out["step_ms"]), each(out["step_ms_rank1"]),
              out["tokens_per_s"],
              sum(g.numel() for g in lm_refs["bf16"]["grads"].values())
              * 4 / 1e6, out["allreduce_ms_mean"], each(ar),
              *out["peak_gb"], out["form_s"], out["shrink_s"],
              out["alone_step_ms"], out["grow_s"], out["join_s"]))
    print("collective LM, ZeRO-1 (rank 0 and the joiner, bf16 batch %d a "
          "rank, %d steps a leg): zero1=False equal to the bf16 leg of the "
          "ranks above and zero1=True equal to both, bit for bit (losses "
          "%s); AdamW state a rank %.1f MB zero1 (%d shards) vs %.1f MB "
          "replicated; ms a step on %s (joiner %s) vs off %s, the parameter "
          "all-gather %.1f ms a step (%s); peak %.1f / %.1f GB; %s" % (
              CLM_BATCH, CLM_ZERO_STEPS, z["losses"],
              z["report_on"]["per_device_bytes"] / 1e6,
              z["report_on"]["num_shards"],
              z["report_off"]["per_device_bytes"] / 1e6,
              each(z["step_ms_on"]), each(z["step_ms_on_joiner"]),
              each(z["step_ms_off"]), z["all_gather_ms_mean"], each(ag),
              *z["peak_gb"], ", ".join(sorted(checks))))
    return out


def mnist_torch_leg(torch):
    """Leg 2 of phase 20: the port's stock-loop example on the card,
    against a port master (a rendezvous server, no gradient sync between
    workers, as the JAX example) in this process."""
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.master.rendezvous import RendezvousServer
    from elasticdl_tpu_torch.master.task_manager import TaskManager
    from elasticdl_tpu_torch.models import mnist_torch
    from elasticdl_tpu_torch.utils import grpc_utils
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    master = Master(TaskManager(
        training_shards=[("mem", 0, MNIST_TORCH_RECORDS)],
        records_per_task=64, num_epochs=1),
        rendezvous_server=RendezvousServer(grace_secs=0.1))
    master.prepare()
    models = []
    build = mnist_torch.build_torch_model

    def keep(seed=0):
        models.append(build(seed))
        return models[-1]

    mnist_torch.build_torch_model = keep
    try:
        channel = grpc_utils.build_channel("localhost:%d" % master.port)
        grpc_utils.wait_for_channel_ready(channel)
        mc = MasterClient(channel, worker_id=0)
        t0 = time.perf_counter()
        loss, batches = mnist_torch.train(
            mc, n_records=MNIST_TORCH_RECORDS, batch_size=MNIST_TORCH_BATCH,
            device=DEVICE)
        loop_s = time.perf_counter() - t0
        finished = master.task_manager.finished()
    finally:
        mnist_torch.build_torch_model = build
        master.stop()
    on_card = [p.device.type == "cuda" for m in models
               for p in m.parameters()]
    want = MNIST_TORCH_RECORDS // MNIST_TORCH_BATCH
    if not (batches == want and math.isfinite(loss) and finished
            and on_card and all(on_card)):
        fail("collective LM, leg 2 (mnist_torch): %d batches (want %d), "
             "loss %r, master finished %s, parameters on the card %s" % (
                 batches, want, loss, finished, on_card))
    print("collective LM, leg 2 (mnist_torch, the wrap-your-own-loop API): "
          "%d batches of %d over %d records on %s in %.2f s, final loss "
          "%.4f, the master's tasks finished, every parameter on the card"
          % (batches, MNIST_TORCH_BATCH, MNIST_TORCH_RECORDS,
             torch.cuda.get_device_name(0), loop_s, loss))
    return {"batches": batches, "loss": loss, "loop_s": loop_s}


def collective_lm_phase(torch, lm_refs):
    return {"ranks": clm_ranks_leg(torch, lm_refs),
            "mnist_torch": mnist_torch_leg(torch)}


# MobileNetV2, the predict and evaluate jobs, and the job's observability
# surfaces (phase 21).  Leg 1: MobileNetV2 (2,236,682 parameters, the
# CIFAR-10 stem, seeded weights) through the port's CollectiveTrainer at
# batch MB_BATCH, float32 (TF32 off) and bf16, MB_STEPS steps each on one
# seeded batch; its norms are flax's GroupNorm in plain torch ops (no
# kernel).  Step 1 is held against the port's CPU runs from the same
# weights and batch: the loss against the CPU's float32 at MB_LOSS_RTOL;
# each gradient leaf by its relative distance (norm_rel) from the CPU's
# float64 run's gradient, within MB_FLOOR_X x the distance of the CPU's
# own run at the same dtype (float32, or bf16 autocast) from it, at least
# MB_GRAD_MIN.  The float64 reference stays on the CPU: a backward that
# is wrong on the card at every dtype would move a float64 run there with
# it.  A fixed limit would not do: this model's gradients at
# init are ill-conditioned (at batch 128 on a CPU the float32 leaves sit
# up to 0.9 % from float64, the bf16 ones up to 89 %: GroupNorm scale
# gradients are sums that nearly cancel; tests/test_torch_mobilenet.py
# has the float32 case leaf by leaf).  Leg 2:
# the job types and surfaces in this process, as phase 17's leg 1: a
# resnet50_cifar10 checkpoint written by one step, then a
# ``--job_type predict`` master (``master.main.build_master``, its status
# server from ``start_status_server`` on ``--status_port 0``) and a
# worker (``worker.main.build_worker``) over JOB_RECORDS synthetic CIFAR
# records, JOB_MINIBATCHES minibatches of JOB_BATCH a task, run three
# times: untraced, under ``device_trace`` (the checked one), untraced, so
# that the profiler's cost is read on the same job; then a ``--job_type
# evaluate`` job over the same records.
MB_BATCH = 128
MB_STEPS = 10
# Seeded random weights: the zoo's 0.05 sends the loss up over 10 steps on
# one batch (2.57 -> 14.5 at batch 16 on a CPU), as phase 7's 1e-2 did.
MB_LR = TRAIN_LR
# Step-1 loss, card against the CPU's float32: float32 sums in another
# order (a few ulp of ~2.3); bf16 rounds every activation (2^-9).
MB_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
MB_FLOOR_X = 4.0
MB_GRAD_MIN = 1e-5
JOB_RECORDS = 1024
JOB_BATCH = 128
JOB_MINIBATCHES = 2
JOB_TASKS = JOB_RECORDS // (JOB_BATCH * JOB_MINIBATCHES)
# Predicted rows against the in-process forward of the restored
# checkpoint on the same batches: the same module and cuDNN algorithms,
# float32 with TF32 off; absolute, scaled by the largest |logit|.
JOB_ROW_TOL = 1e-5
PHASE21_BUDGET_S = 45.0


def mobilenet_grads(module):
    return {name: p.grad.detach().double().cpu().clone()
            for name, p in module.named_parameters()}


def mobilenet_leg(torch):
    """Leg 1 of phase 21; returns its numbers."""
    from elasticdl_tpu_torch.models import mobilenet
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    use_float32_numerics()
    spec = mobilenet.model_spec(learning_rate=MB_LR)
    rng = np.random.RandomState(21)
    xs = rng.rand(MB_BATCH, 32, 32, 3).astype(np.float32)
    ys = rng.randint(0, 10, size=MB_BATCH).astype(np.int32)
    # Every trainer below starts from these (rng_seed 0's) weights.
    weights = spec.init_fn("cpu", 0).state_dict()
    cpu, cpu_error = {}, []

    def references():
        t0 = time.perf_counter()
        try:
            for name in ("float32", "bfloat16", "float64"):
                trainer = CollectiveTrainer(
                    spec, batch_size=MB_BATCH, device="cpu",
                    use_bf16_compute=name == "bfloat16")
                if name == "float64":
                    trainer.module.double()
                trainer.set_params(weights)
                loss, _ = trainer.train_minibatch(
                    xs.astype(np.float64 if name == "float64"
                              else np.float32), ys)
                cpu[name] = (float(loss), mobilenet_grads(trainer.module))
                del trainer
        except Exception as e:  # re-raised by the main thread
            cpu_error.append(e)
        cpu["seconds"] = time.perf_counter() - t0

    def card_run(dtype, before_timing=None):
        """The first step's loss and gradients, then MB_STEPS - 1 timed
        steps; ``before_timing`` runs between the two."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold is not this model's
        held = torch.cuda.memory_allocated()
        trainer = CollectiveTrainer(spec, batch_size=MB_BATCH, device=DEVICE,
                                    use_bf16_compute=dtype == "bfloat16")
        trainer.set_params(weights)
        x, y = torch.from_numpy(xs).to(DEVICE), torch.from_numpy(ys).to(
            DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(trainer.train_minibatch(x, y)[0])]
        first_s = time.perf_counter() - t0
        grads = mobilenet_grads(trainer.module)
        if before_timing is not None:
            before_timing()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MB_STEPS - 1):
            losses.append(trainer.train_minibatch(x, y)[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (MB_STEPS - 1)
        losses = [float(v) for v in losses]
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail("phase 21, MobileNetV2 %s: the loss did not fall over %d "
                 "steps on one batch: %s" % (dtype, MB_STEPS, losses))
        off = [n for n, p in trainer.module.named_parameters()
               if p.device.type != torch.device(DEVICE).type]
        if off:
            fail("phase 21, MobileNetV2: parameters off the card: %s"
                 % off[:5])
        del trainer
        torch.cuda.empty_cache()
        return {"losses": losses, "grads": grads, "first_s": first_s,
                "ms": ms, "peak": peak}

    # The CPU references run beside the bf16 trainer's first step (about
    # 8 s before its kernels run) and are joined before any timed step
    # and any check.
    t0 = time.perf_counter()
    card = {"float32": card_run("float32")}
    refs = threading.Thread(target=references, daemon=True)
    refs.start()
    card["bfloat16"] = card_run("bfloat16", before_timing=refs.join)
    leg_s = time.perf_counter() - t0
    if cpu_error:
        fail("phase 21, MobileNetV2: the CPU references failed: %r"
             % cpu_error[0])
    exact = cpu["float64"][1]
    floors = {dtype: {k: norm_rel(cpu[dtype][1][k], exact[k]) for k in exact}
              for dtype in ("float32", "bfloat16")}
    out = {"cpu_reference_s": cpu["seconds"], "leg_s": leg_s,
           "batch": MB_BATCH,
           "params": sum(v.numel() for v in weights.values())}
    for dtype, run in card.items():
        loss1, grads, ms = run["losses"][0], run["grads"], run["ms"]
        want = cpu["float32"][0]
        if not abs(loss1 - want) <= MB_LOSS_RTOL[dtype] * abs(want):
            fail("phase 21, MobileNetV2 %s: step-1 loss %.7f, the CPU's "
                 "%.7f (rtol %g)" % (dtype, loss1, want, MB_LOSS_RTOL[dtype]))
        worst = (0.0, None, 0.0)
        for name, ref in exact.items():
            err = norm_rel(grads[name], ref)
            limit = MB_FLOOR_X * max(floors[dtype][name], MB_GRAD_MIN)
            if not err <= limit:
                fail("phase 21, MobileNetV2 %s: step-1 gradient of %s is "
                     "%.3g from the CPU's float64 (limit %.3g; the CPU's "
                     "own %s run %.3g)" % (dtype, name, err, limit, dtype,
                                           floors[dtype][name]))
            if err / limit > worst[0]:
                worst = (err / limit, name, err)
        out[dtype] = {"step1_loss": loss1, "cpu_loss": want,
                      "worst_grad_share": worst[0], "worst_leaf": worst[1],
                      "worst_leaf_rel": worst[2],
                      "first_step_s": run["first_s"], "ms_per_step": ms,
                      "images_per_s": MB_BATCH / ms * 1e3,
                      "peak_gb": run["peak"], "losses": run["losses"]}
        print("phase 21, leg 1: MobileNetV2 (%d parameters) %s batch %d on "
              "%s: step-1 loss %.6f (CPU %.6f), worst gradient leaf %s at "
              "%.3g of its limit (%.3g from float64); %.2f ms a step, %.0f "
              "images/s, peak %.2f GB, first step %.2f s, loss %.4f -> %.4f"
              % (out["params"], dtype, MB_BATCH,
                 torch.cuda.get_device_name(0), loss1, want, worst[1],
                 worst[0], worst[2], ms, MB_BATCH / ms * 1e3, run["peak"],
                 run["first_s"], run["losses"][0], run["losses"][-1]))
    print("phase 21, leg 1: %.1f s; the CPU references (float32, bf16, "
          "float64) took %.1f s of it, beside the bf16 first step; the "
          "CPU's worst leaf from its float64: float32 %.3g, bf16 %.3g" % (
              leg_s, cpu["seconds"], max(floors["float32"].values()),
              max(floors["bfloat16"].values())))
    return out


def kernel_events(path, marker):
    """(CUDA kernel events, those whose name holds ``marker``) of a
    Chrome-trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(marker in e.get("name", "") for e in kernels)


def jobs_leg(torch, gn):
    """Leg 2 of phase 21; returns its numbers."""
    with tempfile.TemporaryDirectory() as tmp:
        return run_jobs(torch, gn, tmp)


def run_jobs(torch, gn, tmp):
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils import metrics, timing, tracing
    from elasticdl_tpu_torch.utils.args import (parse_master_args,
                                                parse_worker_args)
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker import main as worker_main
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    ckpt = os.path.join(tmp, "ckpt")
    preds = os.path.join(tmp, "predictions")
    traces = os.path.join(tmp, "traces")
    origin = "synthetic_cifar10:%d" % JOB_RECORDS
    spec_args = ("resnet", "variant=resnet50_cifar10")
    reader = create_data_reader(origin, records_per_shard=JOB_RECORDS)
    end = reader.create_shards()[-1][2]
    records = list(reader.read_records(SimpleNamespace(shard=SimpleNamespace(
        name=reader.create_shards()[0][0], start=0, end=end,
        record_indices=[]))))
    spec = load_model_spec(*spec_args)
    xs, ys = spec.feed(records)
    # The checkpoint: one step of seeded weights, in this process.
    t0 = time.perf_counter()
    writer = CollectiveTrainer(spec, batch_size=JOB_BATCH, device=DEVICE,
                               checkpoint_saver=CheckpointSaver(ckpt))
    writer.train_minibatch(xs[:JOB_BATCH], ys[:JOB_BATCH])
    writer.save_checkpoint()
    writer.flush_checkpoints()
    del writer
    ckpt_s = time.perf_counter() - t0
    # The in-process forward the jobs are held to.
    ref = CollectiveTrainer(spec, batch_size=JOB_BATCH, device=DEVICE,
                              checkpoint_saver=CheckpointSaver(ckpt))
    if not ref.init_from_checkpoint():
        fail("phase 21, leg 2: no checkpoint in %s" % ckpt)
    want = np.concatenate([ref.predict_minibatch(xs[i:i + JOB_BATCH])
                           for i in range(0, JOB_RECORDS, JOB_BATCH)])
    del ref
    accuracy = metrics.Accuracy()
    accuracy.update(want, ys)
    want_acc = float(accuracy.result())
    common = ["--model_zoo", spec_args[0], "--model_params", spec_args[1],
              "--data_origin", origin, "--batch_size", str(JOB_BATCH),
              "--num_minibatches_per_task", str(JOB_MINIBATCHES),
              "--checkpoint_dir", ckpt]

    def job(job_type, trace, outputs=preds):
        """One job: a master with its status server, a worker; the
        counts zeroed just before the worker's run, read just after."""
        common_job = common + ["--prediction_outputs", outputs]
        margs = parse_master_args(common_job + [
            "--job_type", job_type, "--num_workers", "0",
            "--status_port", "0"])
        master = master_main.build_master(margs)
        master.prepare()
        server = master_main.start_status_server(margs, master)
        seen = {}
        try:
            worker = worker_main.build_worker(parse_worker_args(
                common_job + ["--job_type", job_type, "--worker_id", "0",
                              "--master_addr", "localhost:%d" % master.port]))
            trainer = worker.trainer
            inner = trainer.predict_minibatch if job_type == "predict" \
                else trainer.evaluate_minibatch

            def probe(*args):
                if not seen:
                    # mid-job: the surfaces answer, /profilez refuses
                    # while the device trace runs
                    seen["healthz"] = http_get(server.port, "/healthz")
                    seen["status"] = json.loads(
                        http_get(server.port, "/status"))
                    seen["metrics"] = http_get(server.port, "/metrics")
                    seen["profilez_busy"] = json.loads(http_get(
                        server.port, "/profilez?secs=0.1"))
                return inner(*args)

            if trace:
                setattr(trainer, "predict_minibatch", probe)
                tracing.configure_identity("worker", rank=0)
            torch.cuda.synchronize()
            gn.LAUNCHES = 0
            ctx = (timing.device_trace(traces) if trace
                   else contextlib.nullcontext())
            with ctx:
                t0 = time.perf_counter()
                worker.run()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            launches = gn.LAUNCHES
            counts = master.task_manager.counts()
            finished = master.task_manager.finished()
            if trace:
                seen["trace"] = timing.PROFILER.last_trace
                seen["export_s"] = timing.PROFILER.last_export_s
                seen["profilez_after"] = json.loads(http_get(
                    server.port, "/profilez?secs=0.2"))
            history = list(master.evaluation_service.history) if (
                master.evaluation_service is not None) else []
        finally:
            server.stop()
            master.stop()
        if not finished or sum(counts["failed"].values()) or counts[
                "completed"].get(2 if job_type == "predict" else 1) != (
                    JOB_TASKS):
            fail("phase 21, leg 2: the %s job did not finish its %d tasks: "
                 "%s" % (job_type, JOB_TASKS, counts))
        want_launches = GN_PER_FORWARD * JOB_RECORDS // JOB_BATCH
        if launches != want_launches:
            fail("phase 21, leg 2: the %s job launched B1 %d times, want %d"
                 % (job_type, launches, want_launches))
        return {"run_s": run_s, "launches": launches, "counts": counts,
                "history": history, "seen": seen,
                "rows_per_s": JOB_RECORDS / run_s}

    # /profilez writes under $ELASTICDL_TRACE_DIR: here, the leg's dir.
    trace_env = os.environ.get(tracing.ENV_TRACE_DIR)
    os.environ[tracing.ENV_TRACE_DIR] = traces
    try:
        untraced = [job("predict", trace=False,
                        outputs=os.path.join(tmp, "untraced-0"))]
        predict = job("predict", trace=True)
        untraced.append(job("predict", trace=False,
                            outputs=os.path.join(tmp, "untraced-1")))
    finally:
        if trace_env is None:
            os.environ.pop(tracing.ENV_TRACE_DIR)
        else:
            os.environ[tracing.ENV_TRACE_DIR] = trace_env
    seen = predict["seen"]
    rows = np.load(os.path.join(preds, "predictions-worker-0.npz"))[
        "predictions"]
    if rows.shape != want.shape:
        fail("phase 21, leg 2: %s prediction rows, want %s"
             % (rows.shape, want.shape))
    dist = np.abs(rows[:, None, :] - want[None, :, :]).max(-1)
    match = dist.argmin(1)
    if sorted(match.tolist()) != list(range(JOB_RECORDS)):
        fail("phase 21, leg 2: the prediction rows are not each record once")
    row_err = float(np.abs(rows - want[match]).max())
    row_tol = JOB_ROW_TOL * float(np.abs(want).max())
    if not row_err <= row_tol:
        fail("phase 21, leg 2: prediction rows %.3g from the in-process "
             "forward (limit %.3g)" % (row_err, row_tol))
    status, text = seen["status"], seen["metrics"]
    prom = dict(line.rsplit(" ", 1) for line in text.strip().splitlines()
                if not line.startswith("#"))
    same = (prom.get("elasticdl_tasks_todo") == str(status["tasks"]["todo"])
            and prom.get("elasticdl_tasks_doing")
            == str(status["tasks"]["doing"])
            and all(prom.get('elasticdl_tasks_completed{type="%s"}' % k)
                    == str(v)
                    for k, v in status["tasks"]["completed"].items()))
    if seen["healthz"] != "ok\n" or not same:
        fail("phase 21, leg 2: /healthz %r; /status %s against /metrics %s"
             % (seen["healthz"], status["tasks"], text[:400]))
    busy, after = seen["profilez_busy"], seen["profilez_after"]
    if busy.get("ok") is not False or "already running" not in busy.get(
            "error", ""):
        fail("phase 21, leg 2: /profilez during the device trace: %s" % busy)
    if not after.get("ok") or not os.path.exists(after.get("file", "")):
        fail("phase 21, leg 2: /profilez after the device trace: %s" % after)
    trace_path = seen["trace"]
    if os.path.dirname(trace_path) != traces:
        fail("phase 21, leg 2: the device trace went to %s" % trace_path)
    n_kernels, n_b1 = kernel_events(trace_path, "gn_fwd")
    if not n_b1:
        fail("phase 21, leg 2: the device trace %s holds %d CUDA kernel "
             "events, none of B1's" % (trace_path, n_kernels))
    evaluate = job("evaluate", trace=False)
    got_acc = evaluate["history"][-1][1]["accuracy"] if evaluate[
        "history"] else None
    if got_acc != want_acc:
        fail("phase 21, leg 2: the evaluate job's accuracy %r, the "
             "in-process metric %r" % (got_acc, want_acc))
    out = {"checkpoint_s": ckpt_s, "rows": int(rows.shape[0]),
           "row_max_abs_err": row_err, "row_tol": row_tol,
           "predict_rows_per_s": predict["rows_per_s"],
           "predict_run_s": predict["run_s"],
           "predict_untraced_rows_per_s": [u["rows_per_s"]
                                           for u in untraced],
           "launches_predict_job": predict["launches"],
           "launches_evaluate_job": evaluate["launches"],
           "evaluate_rows_per_s": evaluate["rows_per_s"],
           "accuracy": got_acc, "status_mid_job": status["tasks"],
           "profilez_busy": busy["error"],
           "profilez_after_bytes": os.path.getsize(after["file"]),
           "trace_bytes": os.path.getsize(trace_path),
           "trace_export_s": seen["export_s"],
           "trace_kernel_events": n_kernels, "trace_b1_events": n_b1}
    print("phase 21, leg 2: resnet50_cifar10 checkpoint in %.2f s; predict "
          "job of %d records (%d tasks of %d x %d) on %s under device_trace: "
          "%d rows, %.3g from the in-process forward (limit %.3g), %.0f "
          "rows/s, B1 %d launches; /healthz, /status and /metrics agree "
          "mid-job (%s), /profilez refused mid-trace (%s) and captured "
          "after (%d bytes); trace %d bytes, exported in %.2f s, %d CUDA "
          "kernel events, %d of B1; evaluate job: accuracy %.6f = the "
          "in-process metric, %.0f rows/s, B1 %d launches; the same "
          "predict job untraced before and after: %.0f and %.0f rows/s" % (
              ckpt_s, JOB_RECORDS, JOB_TASKS, JOB_MINIBATCHES, JOB_BATCH,
              torch.cuda.get_device_name(0), rows.shape[0], row_err, row_tol,
              predict["rows_per_s"], predict["launches"], status["tasks"],
              busy["error"], out["profilez_after_bytes"], out["trace_bytes"],
              out["trace_export_s"], n_kernels, n_b1, got_acc,
              evaluate["rows_per_s"], evaluate["launches"],
              *out["predict_untraced_rows_per_s"]))
    return out


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            fail("phase 21: GET %s answered %d: %s" % (path, resp.status,
                                                       body[:200]))
        return body
    finally:
        conn.close()


def jobs_phase(torch, gn):
    t0 = time.perf_counter()
    out = {"mobilenet": mobilenet_leg(torch), "jobs": jobs_leg(torch, gn)}
    out["seconds"] = time.perf_counter() - t0
    if out["seconds"] > PHASE21_BUDGET_S:
        fail("phase 21 took %.1f s, over its %.0f s budget" % (
            out["seconds"], PHASE21_BUDGET_S))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="",
                        help="also write every measurement to this JSON")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on an NVIDIA card")
    from elasticdl_tpu_torch.ops import build
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import group_norm as gn

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print("card: %s | torch %s, CUDA %s, %s" % (
        smi, torch.__version__, torch.version.cuda, kind))

    t0 = time.perf_counter()
    outputs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in outputs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print("nvcc %s: %s" % (name, line.strip()))
    print("build: %d kernel sources in %.1f s" % (len(outputs), build_s))

    phase_s = {"build": build_s}
    t0 = time.perf_counter()
    rows, max_err, totals = kernel_phase(torch, gn)
    phase_s["forward kernel"] = time.perf_counter() - t0
    for (batch, name, _), tot in zip(GN_TIMED, totals.values()):
        print("kernel per ResNet-50 forward at batch %d (53 calls, %s): "
              "kernel %.4f ms, plain %.4f ms, F.group_norm %.4f ms, bound "
              "%.4f ms (%s), %.1f %% of the bound" % (
                  batch, name, tot["ms"], tot["plain_ms"],
                  tot["library_ms"], tot["bound_ms"], tot["bound_by"],
                  100 * tot["share_of_bound"]))
    t0 = time.perf_counter()
    bwd_rows, bwd_err, bwd_totals = backward_phase(torch, gn)
    phase_s["backward kernel"] = time.perf_counter() - t0
    for (batch, name, _), tot in zip(GN_TIMED, bwd_totals.values()):
        print("backward kernel per ResNet-50 step at batch %d (53 calls, "
              "%s): kernel %.4f ms, plain %.4f ms, F.group_norm backward "
              "%.4f ms, bound %.4f ms (%s), %.1f %% of the bound" % (
                  batch, name, tot["ms"], tot["plain_ms"],
                  tot["library_ms"], tot["bound_ms"], tot["bound_by"],
                  100 * tot["share_of_bound"]))

    t0 = time.perf_counter()
    module, serve_launches, latencies, serve_err = serving_phase(torch, gn)
    phase_s["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    forward = forward_phase(torch, gn, module)
    del module
    phase_s["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = training_phase(torch, gn)
    phase_s["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flash_err, flash_timed = flash_phase(torch, fa)
    phase_s["flash kernel"] = time.perf_counter() - t0
    # Exports of the LM phases: the dense LM's stays for the LoRA phase.
    exports = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        lm = transformer_phase(torch, fa, exports.name)
        phase_s["transformer serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        flash_bwd_err, bwd_timed = flash_bwd_phase(torch, fa)
        phase_s["flash backward kernels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm_train, lm_refs = lm_training_phase(torch, fa)
        phase_s["transformer training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe = moe_serving_phase(torch, fa, exports.name)
        phase_s["moe serving"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_train = moe_training_phase(torch, fa)
        phase_s["moe training"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        remat = remat_phase(torch, fa)
        phase_s["remat policies"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lora_out = lora_phase(torch, fa, lm["export_dir"])
        phase_s["lora"] = time.perf_counter() - t0
    finally:
        exports.cleanup()
    t0 = time.perf_counter()
    sp = sp_phase(torch, fa, lm_refs)
    phase_s["sequence parallelism"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = process_phase(torch, fa)
    phase_s["process path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coll = collective_phase(torch)
    phase_s["collective path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zero = zero1_phase(torch)
    phase_s["ZeRO-1 path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clm = collective_lm_phase(torch, lm_refs)
    del lm_refs
    phase_s["collective LM"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jobs = jobs_phase(torch, gn)
    phase_s["MobileNetV2, job types, surfaces"] = time.perf_counter() - t0
    print("phase seconds: %s" % ", ".join(
        "%s %.1f" % kv for kv in phase_s.items()))

    f32, bf32 = totals["float32"], bwd_totals["float32"]
    per = "sum of the 53 calls of one ResNet-50 %s, batch %d, float32"
    kernels = [{
        "name": "group_norm_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/group_norm.cu",
        "replaces": "elasticdl_tpu/ops/group_norm.py:98",
        "launches": train["launches"][0],
        "launches_serving": serve_launches,
        "launches_collective_step_per_rank":
            coll["ranks"]["launches_per_step"][0],
        "launches_collective_job": {
            w: c["group_norm_fwd"]
            for w, c in coll["cli"]["launches"].items()},
        "launches_zero1_step_per_rank":
            zero["ranks"]["launches_per_step"][0],
        "launches_zero1_job": {
            w: c["group_norm_fwd"]
            for w, c in zero["cli"]["launches"].items()},
        "launches_predict_job": jobs["jobs"]["launches_predict_job"],
        "max_abs_err": max_err["float32"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "times_are": per % ("forward", BATCH),
        "share_of_bound": f32["share_of_bound"],
        "b32_bf16": gn_sums(totals["bfloat16"]),
        "b128_bf16": gn_sums(totals["bfloat16 b128"]),
    }, {
        "name": "group_norm_bwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/group_norm_bwd.cu",
        "replaces": "elasticdl_tpu/ops/group_norm.py:199",
        "launches": train["launches"][1],
        "launches_collective_step_per_rank":
            coll["ranks"]["launches_per_step"][1],
        "launches_collective_job": {
            w: c["group_norm_bwd"]
            for w, c in coll["cli"]["launches"].items()},
        "launches_zero1_step_per_rank":
            zero["ranks"]["launches_per_step"][1],
        "launches_zero1_job": {
            w: c["group_norm_bwd"]
            for w, c in zero["cli"]["launches"].items()},
        "max_abs_err": bwd_err["float32"],
        "ms": bf32["ms"],
        "plain_ms": bf32["plain_ms"],
        "bound_ms": bf32["bound_ms"],
        "bound_by": bf32["bound_by"],
        "library_ms": bf32["library_ms"],
        "times_are": per % ("training step's backward", BATCH),
        "share_of_bound": bf32["share_of_bound"],
        "b32_bf16": gn_sums(bwd_totals["bfloat16"]),
        "b128_bf16": gn_sums(bwd_totals["bfloat16 b128"]),
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:87",
        "launches": lm["launches"],
        "max_abs_err": flash_err["bfloat16"],
        "ms": flash_timed["bfloat16"]["ms"],
        "plain_ms": flash_timed["bfloat16"]["plain_ms"],
        "bound_ms": flash_timed["bfloat16"]["bound_ms"],
        "bound_by": flash_timed["bfloat16"]["bound_by"],
        "library_ms": flash_timed["bfloat16"]["library_ms"],
        "times_are": "one call at the flagship long prefill, q, k, v "
                     "[8, 16, 2048, 64] bfloat16, causal; launches over "
                     "%d served :predict requests" % REQUESTS,
        "launches_training_step": lm_train["launches_per_step"][0],
        "launches_moe_request": moe["launches_per_request"][0],
        "launches_moe_training_step": moe_train["launches_per_step"][0],
        "launches_lora_training_step": lora_out["launches_per_step"][0],
        "launches_lora_request": lora_out["served_launches"][0],
        "launches_remat_step": {k: v["launches_per_step"][0]
                                for k, v in remat.items()},
        "launches_process_path_step":
            proc["in_process"]["launches_per_step"][0],
        "launches_collective_lm_step_per_rank": [
            n[0] for n in clm["ranks"]["launches_per_step"]],
        "d128": {key: flash_timed["bfloat16 d128"][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "library_ms")},
    }]
    for i, (part, line) in enumerate((("dq", 354), ("dkv", 429))):
        row = bwd_timed[(part, "bfloat16")]
        kernels.append({
            "name": "flash_attention_bwd_" + part,
            "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": "elasticdl_tpu/ops/flash_attention.py:%d" % line,
            "launches": lm_train["launches_per_step"][1 + i],
            "launches_moe_training_step":
                moe_train["launches_per_step"][1 + i],
            "launches_lora_training_step":
                lora_out["launches_per_step"][1 + i],
            "launches_remat_step": {k: v["launches_per_step"][1 + i]
                                    for k, v in remat.items()},
            "launches_process_path_step":
                proc["in_process"]["launches_per_step"][1 + i],
            "launches_collective_lm_step_per_rank": [
                n[1 + i] for n in clm["ranks"]["launches_per_step"]],
            "max_abs_err": flash_bwd_err["bfloat16"][0],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "times_are": "one call at the flagship training shape, q, k, v "
                         "[8, 16, 2048, 64] bfloat16, causal; plain_ms and "
                         "library_ms are the whole backward (dq, dk, dv): "
                         "the plain version's and scaled_dot_product_"
                         "attention's through autograd; launches in one "
                         "training step of the flagship LM",
            "d128": {key: bwd_timed[(part, "bfloat16 d128")][key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms")},
        })
    part = sp["partial_timed"]
    sp2_train = sp["sp2_legs"][1]          # the bf16 training leg, by rank
    kernels.append({
        "name": "flash_attention_partial_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:87",
        "launches": sum(r["launches_per_step"][1] for r in sp2_train),
        "launches_per_rank": [r["launches_per_step"][1] for r in sp2_train],
        "launches_sp4_step1_per_rank": [
            r["step1_launches"][1] for r in sp["sp4_legs"][0]],
        "max_abs_err": sp["partial_max_abs_err"]["bfloat16"],
        "ms": part[("bfloat16", True)]["ms"],
        "plain_ms": part[("bfloat16", True)]["plain_ms"],
        "bound_ms": part[("bfloat16", True)]["bound_ms"],
        "bound_by": part[("bfloat16", True)]["bound_by"],
        "library_ms": None,
        "times_are": "one call at the sp=2 ring's diagonal block, q, k, v "
                     "[8, 16, 1024, 64] bfloat16, causal (the launch "
                     "elasticdl_tpu/ops/flash_attention.py:225 with "
                     "normalize=False); launches in one training step of "
                     "the flagship LM at sp=2, summed over the two ranks",
        "noncausal": {key: part[("bfloat16", False)][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "float32": {key: part[("float32", True)][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
    })
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device": kind,
                       "torch": torch.__version__,
                       "build_s": build_s, "shapes": rows,
                       "per_forward": totals, "max_abs_err": max_err,
                       "bwd_shapes": bwd_rows, "bwd_per_step": bwd_totals,
                       "bwd_max_abs_err": bwd_err,
                       "serve_latency_ms": latencies,
                       "serve_max_abs_err": serve_err,
                       "forward_ms": forward, "train": train,
                       "flash_max_abs_err": flash_err,
                       "flash_timed": flash_timed, "lm": lm,
                       "flash_bwd_errors": flash_bwd_err,
                       "flash_bwd_timed": {"%s %s" % k: v for k, v in
                                           bwd_timed.items()},
                       "lm_train": lm_train, "moe": moe,
                       "moe_train": moe_train, "remat": remat,
                       "lora": lora_out,
                       "sp": {k: v for k, v in sp.items()
                              if k != "partial_timed"},
                       "partial_timed": {"%s causal=%s" % k: v for k, v in
                                         part.items()},
                       "process_path": proc,
                       "collective_path": coll,
                       "zero1_path": zero,
                       "collective_lm": clm,
                       "jobs_phase": jobs,
                       "phase_s": phase_s,
                       "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
