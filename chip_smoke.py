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
    served batch (4) and at batch 32 in float32 and bfloat16, at
    bench.py's batch (128) in bfloat16 and at the serving fleet's other
    pad buckets (1, 2, 8) in float32, ReLU off and on, plus a
    large-mean case; at each, its custom op (``group_norm_op``, what a
    servable program runs) bitwise the kernel, and the op's fake
    outputs the kernel's shapes, dtypes and strides; then, per shape at batch 32 in both dtypes and at
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
    exporter, served through its program by the port's HTTP server on
    the card, and answers three :predict requests of four images;
    predictions must match the exported module run with the plain
    GroupNorm, and the forward kernel must have launched 53 times per
    forward;
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
 9. transformer serving: the flagship LM (vocab 32768, dim 1024, 16
    heads) at LM_SERVE_LAYERS (12) of its 24 layers (234.9 M parameters,
    seeded random weights, bf16
    compute) exported with the port's ``export_generate`` (greedy,
    prompt 128, 128 new tokens), served by the port's HTTP server on the
    card and queried with three :predict requests of 8 prompts; the
    kernel must launch 12 times per request (once per layer of prefill)
    and each prompt must come back unchanged; then, on the same module
    with plain attention: teacher forcing over the generated sequences,
    prefill logits in bf16, and in float32 with TF32 off at T=2048,
    batch 2; then prefill time at batch 8, T=128 and T=2048, with the
    kernel and with plain attention; then A12b (A12B_NEW): a second
    export with 32 new tokens served by a batching endpoint (pad buckets
    1, 2, 4, 8) to concurrent clients of 1-3 prompts, each answer its
    rows of the padded batch the executor ran and that batch a direct
    predict's bit for bit, B3 12 launches a batch; batches, occupancy,
    p50/p99 latency, generated tokens/s, the share equal served alone;
    then generate's ms a token at batch 8, greedy and sampled
    (SAMPLED_TEMPERATURE);
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
    remat=True, dense cross entropy.  First, at LM_GRAD_LAYERS of its
    layers, in float32 with TF32 off at batch 2: step-1 gradients with
    the kernels against the plain Function (``flash_attention_ref``), and
    remat=False and xent_chunk=512 against remat=True; the same
    kernels-vs-plain check at the main path's settings (bf16 compute,
    batch 8), to whose limits remat=False, "dots" and "attn" are then
    held against remat=True (launches B3 1, 2, 2 a layer; B4, B5 1).
    Then, at all 24 layers, one step
    whose launches are counted (B3 48 times, forward and remat
    recompute; B4 and B5 24 times each) and after which every parameter
    must hold a finite gradient; LM_TRAIN_STEPS timed steps on the same batch (the loss
    must fall), ms per step, tokens/s and the model-FLOP share (mfu);
    LM_PLAIN_STEPS with the plain Function; then, at LM_GRAD_LAYERS
    layers again, trained LM_PLAIN_STEPS steps, a checkpoint (parameters
    and AdamW moments in the JAX names and layouts) restored into a fresh
    trainer bit for bit, with the same next loss;
12. MoE serving: Flagship-MoE (the flagship widths with 8 experts, top-2
    gating, capacity factor 2, aux weight 0.01) at MOE_SERVE_LAYERS (2)
    of its 24 layers, seeded random weights, bf16 compute, exported with
    ``export_generate`` in float32 (the temporary directory's free space
    printed first; a shortfall fails), served over HTTP (MOE_REQUESTS
    requests of 8 prompts, 128 + 128 tokens, 2 B3 launches each); the
    first request's 2 prefill attention calls held against the plain
    version on their own q, k, v (FLASH_TOL) and its served tokens
    against in-process ``generate``; the tokens teacher-forced through
    plain attention by prefill and decode steps (an MoE forward over the
    whole sequence drops tokens past an expert's capacity, a decode step
    never does), the share past LM_TF_TOL held against plain-vs-plain
    (MOE_TF_SHARE), and the prefill logits held against plain attention's
    as the dense LM's; then phase 9's A12b leg on the MoE module;
13. MoE training at MOE_TRAIN_LAYERS (6) of its 24 layers, batch 8 x
    2048, bf16 compute, AdamW, remat: step-1 gradients with the kernels
    against the plain Function, leaf by leaf against their floors (router
    and expert leaves nonzero); one counted step (B3 12, B4 6, B5 6)
    and MOE_TRAIN_STEPS timed steps through
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
    timed against its bound, ``_partial_ref`` and, in bf16,
    ``aten._scaled_dot_product_flash_attention`` (its output and
    log-sum-exp carry acc, l and m); then ranks spawned on
    the card (``parallel/launch.py``: one process each, gloo groups whose
    transport stages tensors through the host, joins under a time limit):
    at sp=2, ring attention at the flagship's attention shape in bf16
    (and f32 at batch 2) against attention_local on one rank and the dense
    f32 softmax; the flagship's widths at MULTI_RANK_LAYERS (2) layers
    (batch 8 x 2048, bf16, AdamW, remat) through the port's SPMDTrainer:
    step-1 loss and gradients against the sp=1 path at that depth
    (``multi_rank_refs``: f32 at batch 2, bf16 at batch 8), one counted
    step (B3p 2 L launches on rank 0, 4 L on rank 1 for L layers; B3, B4
    and B5 none), SP_TIMED_STEPS timed steps (the loss must fall; ms per
    step, tokens/s and peak memory per rank) and a checkpoint saved at
    sp=2, restored at sp=1 in this process (the same loss before and
    after one more step); then, in the same two processes, each over a
    mesh of its own, the A18 legs (A18_LEGS): pp=2 through the zoo
    entry's ``mesh=`` and ``pipeline_microbatches=4`` (a GPipe schedule,
    B3 8, B4 4, B5 4 a step a rank at [2, 16, 2048, 64]), tp=2 (Megatron
    splits, B3 4, B4 2, B5 2 at [8, 8, 2048, 64]) and ep=2 (Flagship-MoE,
    8 experts top-2, at the same depth; B3 4, B4 2, B5 2), each: step-1
    loss and gradients (each block summed over the ranks that hold it,
    gathered whole) against the single process at that depth
    (``multi_rank_refs``, an MoE reference of its own for ep), one
    counted step, A18_TIMED_STEPS timed steps (the loss must fall; ms a
    step, tokens/s, peak memory a rank); the tp=2 leg's checkpoint,
    gathered whole, restored with no mesh in this process (the same loss
    before and after one more step); each world's and leg's seconds on
    a line; at sp=4 (ring distances 2 and 3), ring
    attention at batch 2, causal and with a window that bands two blocks
    and skips the third, and the same model's step-1 gradients (rank r launches
    B3p 2 L (r + 1) times);
17. the master/worker process path: in this process, the flagship LM at
    full width and MULTI_RANK_LAYERS (2) layers (remat) trained through
    the port's master (TaskManager and gRPC servicer) and Worker task
    loop, two jobs of 4 tasks of 4 minibatches at batch 8 x 2048, each
    step launching B3 8 times and B4, B5 4 times, every parameter on the
    card, the loss
    falling in each job; ms per step and tokens/s beside the direct
    CollectiveTrainer step timed before, between and after the jobs on
    the same trainer; then the master CLI
    (``python -m elasticdl_tpu_torch.master.main``) with two worker
    processes on the card (no device variable: the workers' default),
    the flagship's widths at 4 layers from an empty kernel cache, worker
    0 killed -9 after its first checkpoint: its task requeued, a
    replacement launched that restores the checkpoint and trains, the
    job finishing with exit 0 and no failed task; start-up, checkpoint
    and recovery seconds; and the killed-master drill
    (``run_master_kill_drill``, DRILL_RECORDS), run beside phase 16's
    worlds (``Beside``) and waited for before leg 1: a journaled
    resnet50_cifar10 job of two worker processes on the card, its master
    SIGKILLed and restarted with --num_workers 0 on the same port, the
    same workers riding the outage; every task completed once, none
    failed, one connected trace, B1/B2 53 a pass; kill -9 to the first
    task after the restart;
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
    exit 0 with no failed task.  Between the two, the A4c mesh leg
    (MESH_ROWS_SEED): the last world of 2 re-formed under
    ``elastic_mesh_builder(tp=2)`` (dp=1, tp=2), a step on rows both
    replicas share (one loss, both states bit for bit on the ranks' own
    cuDNN settings, B1/B2 53, within phase 18's limits of the mean of
    the two ranks' steps alone from the same state, ZeRO-1 over dp
    alone), then the data mesh again;
20. the collective LM: the flagship's widths at MULTI_RANK_LAYERS (2)
    layers (bf16, AdamW, remat) trained by two ranks spawned on the card
    at batch 4 each, the world formed as phase 18's: step-1 loss and
    gradients in float32 at batch 1 a rank and in bf16 at 4 a rank
    against the single process at the global batch and the same depth
    (``multi_rank_refs``; each leaf within its limit of the dense f32
    softmax path's), B3/B4/B5 2 L/L/L launches a step a rank, ms a step, the all-reduce's ms, tokens/s and peak memory a
    rank; the world re-formed 2 -> 1 -> 2 in place (parameters and AdamW
    moments kept bit for bit, a joiner with other weights adopting rank
    0's); then zero1=False and zero1=True, CLM_ZERO_STEPS steps each
    (the zero1=False leg reproduces the bf16 leg's steps, and ZeRO-1
    equals both bit for bit: losses, parameters, the whole AdamW state),
    the AdamW state a rank, ms a step both ways and the parameter
    all-gather's ms; then the port's wrap-your-own-loop example
    (``models/mnist_torch.py``: an ElasticDataset, 16 batches of 32, a
    port master in this process) on the card; then the LoRA collective
    CLI job (LORA_CLI_PARAMS, ``--zero1 true``, two workers) with worker
    0 killed -9: exit 0 with no failed task, B3 2 L and B4, B5 L launches
    a pass in each surviving worker;
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
22. DeepFM on the parameter-server path: in this process, the port's
    ParameterServerTrainer on the card against two PS shard processes
    (``python -m elasticdl_tpu_torch.ps.server``, Adam on the native
    kernels) at bench_deepfm.py's shape (batch 512, vocab 100,000, 10
    fields, dimension 8, 4 dense features, hidden (128, 64)): step 1 on
    the card held against the same step on the CPU on the same pulled
    rows (loss, every dense gradient, both tables' row gradients), then
    PS_TIMED_STEPS steps under atomic sync, under async shards with the
    push serialized (bench_deepfm.py's settings) and under async push
    window 1 with the next batch's rows prefetched, a fleet each (the
    loss must fall): DeepFM steps/s and the ms of dense pull, embedding
    pull, device step, push and push drain a step, with the card's name
    and power limit; no kernel of
    ops/ launches.  Then the master CLI with ``--distribution_strategy ps
    --num_ps 2 --num_workers 2 --model_zoo deepfm --data_origin
    synthetic_ctr:N`` (workers on the card), PS shard 0 killed -9 once a
    checkpoint label is committed: the master relaunches it on its port,
    it restores the label, the workers ride the outage and reconcile, and
    the job ends exit 0 with no failed task, no worker relaunched and a
    newer committed label; recovery seconds.  The phase fails past
    PHASE22_BUDGET_S;
23. the serving fleet: seeded ResNet-50 exports (224x224x3, 1000
    classes) written by one ContinuousExporter (one trace for both
    versions), version 1 (seed 0) in a versioned base; leg 2's replica
    processes are launched then and load it while leg 1 runs.  Leg 1, in
    this
    process: the port's ModelEndpoint with the micro-batcher
    (--max_batch_size 8: pad buckets 1, 2, 4, 8, each warmed at load,
    5 ms window) behind ``build_server``; FLEET_CLIENTS threads send
    FLEET_REQUESTS requests each of 1-3 images, half JSON, half binary
    frames: every answer 200 with its own rows, each row within
    1e-3 * max|logit| of the exported module run with the plain
    GroupNorm,
    fewer batches than requests, ``batcher.warmed_models`` 1 on /statz,
    B1 launched exactly 53 x (executed batches + 4 warmed buckets) and
    no CUDA tensor handed to the plain GroupNorm; images/s, p50 and p99
    latency, mean batch occupancy, the queue wait's p99; then the same
    load with batching off (53 launches a request), and the same
    requests all as binary frames, batched (what JSON costs); then one
    batch of 8 executed by the program route and by the zoo route of the
    same export, in turns (median host ms each), and one program-route
    batch under ``torch.profiler`` (its kernels' device ms).  Leg 2:
    two replica processes (``python -m elasticdl_tpu_torch.serving.server
    --fleet_managed true``, launched by the fleet's spawner, on the
    card) behind the port's Router in this process; version 2 (seed 2)
    published under a storm of keyed JSON and binary requests through
    the router: every answer 200, stamped 1 or 2 and matching its
    version's plain-GN reference, none sent after the commit barrier
    stamped 1; then one replica sent SIGTERM: it exits 0 within its
    grace, the router ejects it, no client sees an error; publish to
    commit and SIGTERM to exit seconds.  The phase fails past
    PHASE23_BUDGET_S;
24. the online-learning loop, ResNet-50 at full width (224x224x3, 1000
    classes, float32, TF32 off), seeded weights.  Leg 1, on the card in
    this process: the port's CollectiveTrainer takes 4 steps at batch 8
    on one batch (the loss must fall) with a ContinuousExporter (wire
    format "frame") every 2 steps; each version goes through
    ``stream_to`` and a FrameClient to an aggregator process (``python
    -m elasticdl_tpu_torch.aggregation.main``, mean over a window of 2)
    that publishes into a versioned base a ModelEndpoint serves through
    the program (pad buckets 1, 2, 4, 8, warmed at load and at the hot
    swap).  The program is traced once and only the first frame carries
    it; the published weights are the host mean of the two exported
    versions bit for bit; the endpoint commits the newer version; every
    answer (1 in 3 JSON, the rest frames) is 200, stamped with it and
    each row within 1e-3 * max|logit| of the plain-GN module holding the
    mean; B1 launched by the program exactly 53 x (executed batches + 4
    warmed buckets), no CUDA tensor handed to the plain GroupNorm; the
    same program loads on the CPU and answers a batch of 2 within the
    same tolerance.  Leg 2: ``ModelExporter`` at train end, float32 and
    int8, each served on the card through its program (53 launches a
    forward): float32 rows within 1e-3 * max|logit| of the plain-GN
    module, int8 rows within INT8_REL_TOL * max|logit| of float32's; the
    float32 forward program, traced on the card, holds 53 GroupNorm op
    nodes, no copy feeding one and no layout op on a weight; a
    resnet_small_cifar10 program written on the CPU answers on the card
    within 1e-3 * max|logit| of the CPU.
    Recorded: trace-and-serialize seconds, steady-state export seconds,
    frame bytes, ingest -> publish and publish -> commit seconds, the
    artifacts' bytes, load seconds by the program and the zoo route.
    The phase fails past PHASE24_BUDGET_S;
25. the CTR zoo and the preprocessing library: leg 1, each model of the
    slice on the parameter-server path, two port PS shard processes of
    its own (native Adam, atomic sync): DCN and xDeepFM at phase 22's
    DeepFM shape, wide & deep, the census DNN and both census SQLFlow
    variants at their ``model_spec`` defaults over synthetic census
    records (fed through the port's preprocessing library), batches of
    512; step 1 on the card against a CPU trainer that pulled the same
    initial parameters (logits, loss, dense and row gradients), then 2
    warm-up and 10 timed steps through ``ParameterServerTrainer``: the
    loss finite and falling, steps/s, the trainer's ms a step (dense
    pull, embedding pulls, device step, push) and the feed's ms a batch;
    ``PSEmbedding``'s lookup on the card equal to a direct pull.  Leg 2,
    the collective path on the card through ``CollectiveTrainer``: wide &
    deep with its tables local (``model_handler.localize_spec``), its
    first loss against the PS form's on the same table values, falling;
    iris from an SQLite table through the ``.db`` origin and heart from
    CSV, each to the accuracy its JAX test asks.  No kernel of ``ops/``
    may launch.  The phase fails past PHASE25_BUDGET_S;
26. the control plane: leg 1, the port's CLI (``python -m
    elasticdl_tpu_torch.client.main train --platform local --jobs_spec``)
    runs the multi-tenant master over a pool of two worker processes on
    the card and two jobs, mnist (512 records) and ResNet-50 at its full
    widths (resnet50_cifar10 on synthetic_cifar10, 2,048 records, batch
    32), each 1 to 2 workers: exit 0 with each job's records accounted
    for once (each job's journal), no worker restarts (the pids), at
    least one move by the resize controller (a ``sched`` assign with a
    ``prev``), ``/status`` listing both jobs running, every trainer of
    the ResNet-50 job launching B1 and B2 53 times a pass (the moved
    worker's among them), a switched worker holding under
    CP_LEFTOVER_BYTES on the card when the new trainer's build starts and
    the ResNet-50 parameters on the card after it, the ResNet-50 losses
    finite; recorded: the seconds to the first move and each job's
    steps/s.  Leg 2, ``inspect`` on the ResNet-50 job's checkpoints and on
    phase 5's export.  Leg 3, ``train --platform k8s --output -`` with
    ``--worker_resource_request cpu=4,memory=16Gi,nvidia.com/gpu=1``: the
    master pod runs ``elasticdl_tpu_torch.master.main`` with
    ``--worker_backend k8s``, and the worker pod the port's
    ``K8sWorkerBackend`` makes from those args carries ``nvidia.com/gpu:
    1`` under ``limits``; no cluster is contacted.  The phase fails past
    PHASE26_BUDGET_S;
27. one JSON line of kernels, then the card's name and power limit, then
    {"ok": true, "device": {...}} as the last line.

Each phase prints its seconds on a line of its own as it ends (``phase
<name>: <s> s``).

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
   JOB_ROW_TOL below;
 - DeepFM on the PS path, the card against the CPU: PS_LOSS_RTOL and
   PS_GRAD_RTOL below; the CTR zoo: CTR_ATOL, CTR_RTOL, CTR_LOSS_RTOL
   and SMALL_ACCURACY below;
 - the serving fleet: each served row against the plain-GN module on
   that row, 1e-3 * max|logit| absolute, as the served logits above
   (rows batched into other buckets than the reference's: cuDNN may
   pick another algorithm for each batch size, so not bitwise).
"""

import argparse
import contextlib
import http.client
import json
import logging
import math
import os
import re
import shutil
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
# The serving fleet's other pad buckets (phase 23 runs B1 at 1, 2, 4
# and 8): the forward kernel against plain there too, float32.
BUCKET_CHECKS = ((1, ("float32",)), (2, ("float32",)), (8, ("float32",)))
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
LM_LAYERS = int(re.search(r"num_layers=(\d+)", LM_PARAMS).group(1))


def lm_params_at(layers):
    """LM_PARAMS with ``layers`` of the flagship's layers."""
    return LM_PARAMS.replace("num_layers=%d" % LM_LAYERS,
                             "num_layers=%d" % layers)


# Phase 9 serves the flagship at LM_SERVE_LAYERS of its 24 layers, and
# phase 15's LoRA adapts that export (24 until the A18 legs of phase 16
# needed the room: the export 1.74 GB at 24 layers, PERF.md §6, PR 21).
LM_SERVE_LAYERS = 12
LM_SERVE_PARAMS = lm_params_at(LM_SERVE_LAYERS)
# A12b: generation through the micro-batcher (phases 9 and 12).  A second
# export of the served module with A12B_NEW new tokens (LM_NEW cut for
# time: a size cut), served by an endpoint that batches: A12B_CLIENTS
# concurrent clients send A12B_REQUESTS requests each of 1-3 prompts,
# coalesced and padded to the buckets.  Gates: each answer is its rows of
# the batch the executor formed, and that batch's output what one direct
# predict of the same padded input gives, bit for bit; one B3 launch a
# layer per executed batch.  The share of requests whose tokens equal the
# request served alone is reported, not gated: bf16 GEMMs may round
# otherwise at another batch M.
A12B_NEW = 32
A12B_BUCKETS = [1, 2, 4, 8]
A12B_CLIENTS = 8
A12B_REQUESTS = 2
A12B_TIMEOUT_MS = 20.0


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
LM_TRAIN_STEPS = 6              # 10 before phase 24 was added
LM_PLAIN_STEPS = 2              # 3 before phase 24 was added
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
# These checks run at the flagship widths and LM_GRAD_LAYERS of its 24
# layers (all 24 until phase 26 was added; the floor is each run's own, so
# the limits follow the depth), and so does the checkpoint round trip
# (parameters and AdamW moments in the JAX names and layouts, restored bit
# for bit, the same next loss): at 24 layers its 5.2 GB were written twice
# and read three times, ~45 s of the phase on the H100's host.
LM_GRAD_BATCH = 2
LM_GRAD_MIN = 1e-5
LM_GRAD_LAYERS = 4
# Flagship-MoE: the flagship widths with the zoo's MoE settings, top-2
# gating over 8 experts (GShard, as Mixtral 8x7B), the JAX defaults of
# capacity factor 2.0 and aux weight 0.01; 2,550 M parameters.  Served as
# the dense LM (MOE_REQUESTS requests), trained at the dense LM's
# training shape.
MOE_PARAMS = LM_PARAMS + ";moe_experts=8;moe_top_k=2"
MOE_REQUESTS = 2
# Served at 2 of its 24 layers and trained at 6: at full depth the 10.2
# GB export and its load took 62 s of the serving phase's ~100 s and a
# training step 1.8 s (NVIDIA H100 80GB HBM3, 700 W); the depth was cut
# to make room for phase 24, and served from 4 layers to 2 for phase
# 16's A18 legs (PERF.md §6).
MOE_SERVE_LAYERS = 2
MOE_TRAIN_LAYERS = 6
MOE_SERVE_PARAMS = MOE_PARAMS.replace("num_layers=%d" % LM_LAYERS,
                                      "num_layers=%d" % MOE_SERVE_LAYERS)
MOE_TRAIN_PARAMS = MOE_PARAMS.replace("num_layers=%d" % LM_LAYERS,
                                      "num_layers=%d" % MOE_TRAIN_LAYERS)
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
LORA_PARAMS = LM_SERVE_PARAMS + ";remat=true;rank=8;alpha=16"
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


def check_custom_op(torch, op, args, got, what):
    """The kernel's custom op (what a servable program runs) on the
    wrapper's inputs: its outputs bitwise the wrapper's ``got``, and its
    fake implementation (what ``torch.export`` traces with) gives the
    same shapes, dtypes, strides and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = op(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, got)):
        fail("%s: the custom op is not bitwise the kernel" % what)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode:
        fake = op(*fake_args)
    meta = [(tuple(t.shape), t.dtype, t.stride(), t.device.type)
            for t in fake]
    want = [(tuple(t.shape), t.dtype, t.stride(), t.device.type)
            for t in out]
    if meta != want:
        fail("%s: the custom op's fake outputs %s, the kernel's %s"
             % (what, meta, want))


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
    batches of BUCKET_CHECKS and CHECK_BATCHES; times at the (batch,
    dtype) of GN_TIMED."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    totals = new_totals()
    for HW, C, model_relu, count in RESNET50_GN:
        inputs = {}
        for batch, names in BUCKET_CHECKS + CHECK_BATCHES:
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
                    check_custom_op(torch, gn.group_norm_op,
                                    (xd, scale, bias, GROUPS, 1e-6, relu),
                                    got, what)
                    max_err[name] = max(max_err[name], err)
                    print("check %-48s max_abs_err %.3g; custom op "
                          "bitwise" % (what, err))
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


def serving_phase(torch, gn, exports):
    """Export, serve and query a seeded ResNet-50 through the port's
    entry points; returns the served module for the forward phase.  The
    export stays under ``exports`` (phase 26 inspects it)."""
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
    export_dir = os.path.join(exports, "resnet50", "1")
    export_servable(export_dir, "resnet", model_params, module,
                    images[0, :1], model_name="resnet50", version=1)
    endpoint = ModelEndpoint(os.path.dirname(export_dir),
                             device="cuda")
    if endpoint.model.program is None:
        fail("serving: the export loaded without its program")
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

    # Reference: the exported module (the served program's weights),
    # with the plain GroupNorm.
    served = module
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
        check_custom_op(torch, fa.flash_attention_op,
                        (q, k, v, causal, scale, window), got, what)
        max_err[name] = max(max_err[name], err)
        print("check %-62s max_abs_err %.3g; custom op bitwise" % (
            what, err))
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
    prompt_len, new = prompts.shape[-1], endpoint._snapshot()[0].generate[
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
    vocab = endpoint._snapshot()[0].module.cfg.vocab_size
    for batch, seq in zip(prompts, generated):
        if seq.shape != (batch.shape[0], prompt_len + new):
            fail("%s generated shape %s" % (name, seq.shape))
        if not np.array_equal(seq[:, :prompt_len], batch):
            fail("%s: the prompt did not come back unchanged" % name)
        if seq.min() < 0 or seq.max() >= vocab:
            fail("%s: generated ids outside the vocab" % name)
    return generated, latencies, launches, endpoint


def batched_lm_leg(torch, fa, module, cfg, tmp, name, seed):
    """A12b (see A12B_NEW): ``module`` exported for generation with
    A12B_NEW new tokens under ``tmp``, served by a batching endpoint to
    concurrent clients."""
    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.serving.batcher import BatchConfig
    from elasticdl_tpu_torch.serving.server import ModelEndpoint

    base = os.path.join(tmp, name + "_batched")
    t0 = time.perf_counter()
    tfm.export_generate(os.path.join(base, "1"), module, cfg,
                        max_new_tokens=A12B_NEW, prompt_len=LM_PROMPT,
                        model_name=name, version=1)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    endpoint = ModelEndpoint(base, device=DEVICE, batching=BatchConfig(
        max_batch_size=A12B_BUCKETS[-1], batch_timeout_ms=A12B_TIMEOUT_MS,
        pad_buckets=A12B_BUCKETS, warm=False))
    load_s = time.perf_counter() - t0
    model = endpoint.model
    direct, batches = model.predict, []

    def recorded(inputs):
        # The executor's one predict a batch: its padded input, output
        # and B3 launches.
        before = fa.LAUNCHES
        got = direct(inputs)
        batches.append((np.array(inputs), np.array(got),
                        fa.LAUNCHES - before))
        return got

    rng = np.random.RandomState(seed)
    requests = [[rng.randint(0, cfg.vocab_size, size=(
        rng.randint(1, 4), LM_PROMPT)).astype(np.int32)
        for _ in range(A12B_REQUESTS)] for _ in range(A12B_CLIENTS)]
    answers, latencies, errors = {}, [], []
    go = threading.Barrier(A12B_CLIENTS)

    def client(c):
        try:
            go.wait()
            for i, rows in enumerate(requests[c]):
                t = time.perf_counter()
                resp = endpoint.predict({"instances": rows.tolist()})
                latencies.append((time.perf_counter() - t) * 1e3)
                answers[(c, i)] = np.asarray(resp["predictions"])
        except Exception as e:  # noqa: BLE001 — failed below
            errors.append(repr(e))

    model.predict = recorded
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(A12B_CLIENTS)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        stats = endpoint.stats()
    finally:
        model.predict = direct
        endpoint.close()
    what = "%s through the batcher" % name
    if errors or len(answers) != A12B_CLIENTS * A12B_REQUESTS:
        fail("%s: %d answers, errors %s" % (what, len(answers), errors[:3]))
    # Each answer is its rows of exactly one executed batch (the batcher
    # pads with copies of a batch's first row, so the first request's
    # rows may match there twice); each batch's output is what a direct
    # predict of its padded input gives.
    for (c, i), answer in answers.items():
        rows = requests[c][i]
        found = {b for b, (inp, out, _) in enumerate(batches)
                 for at in range(len(inp) - len(rows) + 1)
                 if np.array_equal(inp[at:at + len(rows)], rows)
                 and np.array_equal(out[at:at + len(rows)], answer)}
        if len(found) != 1:
            fail("%s: request %d of client %d is its rows of %d executed "
                 "batches, want 1" % (what, i, c, len(found)))
    redo = [np.array_equal(direct(inp), out) for inp, out, _ in batches]
    launches = [n for _, _, n in batches]
    sizes = [len(inp) for inp, _, _ in batches]
    if not all(redo) or launches != [cfg.num_layers] * len(batches) or any(
            n not in A12B_BUCKETS for n in sizes):
        fail("%s: a direct predict of each padded batch equal %s, B3 "
             "launches a batch %s (want %d), batch sizes %s" % (
                 what, redo, launches, cfg.num_layers, sizes))
    alone = [np.array_equal(direct(requests[c][i]), answer)
             for (c, i), answer in sorted(answers.items())]
    rows = sum(len(r) for reqs in requests for r in reqs)
    shutil.rmtree(base)
    out = {"export_s": export_s, "load_s": load_s, "wall_s": wall_s,
           "requests": len(answers), "rows": rows, "batches": len(batches),
           "batch_sizes": sizes,
           "mean_occupancy": stats["mean_batch_occupancy"],
           "latency_ms_p50": float(np.percentile(latencies, 50)),
           "latency_ms_p99": float(np.percentile(latencies, 99)),
           "generated_tokens_per_s": rows * A12B_NEW / wall_s,
           "b3_launches_per_batch": launches,
           "alone_share": sum(alone) / len(alone)}
    print("%s (A12b; prompt %d, %d new tokens, buckets %s, %d clients x %d "
          "requests of 1-3 prompts, %d rows): %d batches padded to %s rows, "
          "mean occupancy %.2f; latency p50 %.1f ms, p99 %.1f ms; "
          "%.1f generated tokens/s over %.2f s; B3 %s a batch; every "
          "answer its rows of the padded batch, bit for bit a direct "
          "predict of it; %.0f %% of requests equal served alone; export "
          "%.1f s, load %.1f s" % (
              what, LM_PROMPT, A12B_NEW, A12B_BUCKETS, A12B_CLIENTS,
              A12B_REQUESTS, rows, len(batches), sizes,
              out["mean_occupancy"], out["latency_ms_p50"],
              out["latency_ms_p99"], out["generated_tokens_per_s"], wall_s,
              launches, 100 * out["alone_share"], export_s, load_s))
    if name == "lm":
        out["decode_ms_a_token"] = sampled_decode_ms(torch, tfm, module, cfg,
                                                     seed)
    return out


# The sampled decode's cost (phase 9, after A12b): generate at a full
# bucket of A12B_BUCKETS[-1] prompts and A12B_NEW new tokens, greedy and
# sampled at SAMPLED_TEMPERATURE (the Gumbel noise hashed on the card,
# models/transformer._step_uniforms), SAMPLED_REPS calls each after one
# warm call; the fastest call's ms over its new tokens, prefill in it.
SAMPLED_TEMPERATURE = 0.8
SAMPLED_REPS = 2


def sampled_decode_ms(torch, tfm, module, cfg, seed):
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, size=(
        A12B_BUCKETS[-1], LM_PROMPT)).astype(np.int32)
    out = {}
    for mode, temperature in (("greedy", 0.0),
                              ("sampled", SAMPLED_TEMPERATURE)):
        times = []
        for _ in range(SAMPLED_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = tfm.generate(module, cfg, prompt, A12B_NEW,
                                  temperature=temperature, seed=seed)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / A12B_NEW)
        if tokens.shape != (len(prompt), LM_PROMPT + A12B_NEW) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            fail("lm %s generate: tokens of shape %s out of the vocab" % (
                mode, tuple(tokens.shape)))
        out[mode] = min(times[1:])
    print("lm generate at batch %d, prompt %d, %d new tokens: %.2f ms a "
          "token greedy, %.2f sampled at temperature %.1f (noise hashed "
          "on the card), prefill included" % (
              len(prompt), LM_PROMPT, A12B_NEW, out["greedy"],
              out["sampled"], SAMPLED_TEMPERATURE))
    return out


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
    """The flagship transformer LM at LM_SERVE_LAYERS layers (seeded
    random weights, bf16 compute) exported with the port's ``export_generate``
    under ``tmp`` (kept: the LoRA phase adapts it), served by the port's
    HTTP server on the card and queried with REQUESTS :predict requests
    of LM_BATCH prompts; then checked against the same module on plain
    attention and timed."""
    import dataclasses

    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()   # as the serving entry point: TF32 off
    spec = load_model_spec("transformer", LM_SERVE_PARAMS)
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

    served = endpoint._snapshot()[0].module
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
    del endpoint
    out["batched"] = batched_lm_leg(torch, fa, served, cfg, tmp, "lm", 9)
    del served
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
    """Step-1 gradients of the flagship LM at LM_GRAD_LAYERS layers through
    the zoo entry's apply_fn and loss_fn, kernels (remat=True) against the
    plain Function (``lm_grads_vs_plain``): in float32 with TF32 off at batch
    LM_GRAD_BATCH x 2048, where remat=False and xent_chunk=512 are then
    held against remat=True to the same limits; and at the main path's
    settings, bf16 compute at batch LM_TRAIN_BATCH x 2048."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()
    grad_params = lm_params_at(LM_GRAD_LAYERS)
    params = grad_params.replace("dtype=bfloat16", "dtype=float32")
    specs = {name: load_model_spec("transformer", params + extra)
             for name, extra in (("remat", ";remat=true"),
                                 ("no_remat", ";remat=false"),
                                 ("xent_chunk", ";remat=true;xent_chunk=512"))}
    cfg = specs["remat"].config
    module = specs["remat"].init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_GRAD_BATCH, cfg.max_seq_len))).to(DEVICE)
    out, grads_k, limit = lm_grads_vs_plain(
        torch, fa, specs["remat"], module, toks,
        "%d-layer f32 (TF32 off)" % LM_GRAD_LAYERS)
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
    del grads_k, module
    torch.cuda.empty_cache()

    spec = load_model_spec("transformer", grad_params + ";remat=true")
    module = spec.init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_TRAIN_BATCH, cfg.max_seq_len))).to(DEVICE)
    bf16, grads_k, limit = lm_grads_vs_plain(
        torch, fa, spec, module, toks,
        "%d-layer bf16 compute" % LM_GRAD_LAYERS)
    loss_k = bf16["loss_kernels"]
    gaps = {}
    for remat in ("false", "dots", "attn"):
        spec_r = load_model_spec("transformer",
                                 grad_params + ";remat=" + remat)
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
    del grads_k, module
    torch.cuda.empty_cache()
    return {"f32": out, "bf16": bf16}


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


def multi_rank_refs(torch, fa):
    """The sp=1 references of the multi-rank LM phases (16 and 20): the
    flagship's widths at MULTI_RANK_LAYERS layers, step-1 gradients with
    the kernels held against the plain Function (``lm_grads_vs_plain``)
    and the dense f32 softmax path's kept, in float32 with TF32 off at
    batch LM_GRAD_BATCH and in bf16 at LM_TRAIN_BATCH, and Flagship-MoE
    in bf16 at LM_TRAIN_BATCH (phase 16's ep=2 leg), on seeded tokens
    (``sp1_reference``)."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()
    rng = np.random.RandomState(11)
    params = LM_PARAMS.replace("num_layers=%d" % LM_LAYERS,
                               "num_layers=%d" % MULTI_RANK_LAYERS)
    moe = MOE_PARAMS.replace("num_layers=%d" % LM_LAYERS,
                             "num_layers=%d" % MULTI_RANK_LAYERS)
    refs = {}
    for name, p, batch in (
            ("f32", params.replace("dtype=bfloat16", "dtype=float32"),
             LM_GRAD_BATCH), ("bf16", params, LM_TRAIN_BATCH),
            ("moe", moe, LM_TRAIN_BATCH)):
        spec = load_model_spec("transformer", p + ";remat=true")
        cfg = spec.config
        module = spec.init_fn(DEVICE, seed=0)
        toks = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, size=(batch, cfg.max_seq_len))).to(DEVICE)
        unrounded = {}
        check, grads_k, _ = lm_grads_vs_plain(
            torch, fa, spec, module, toks, "%d-layer %s" % (
                MULTI_RANK_LAYERS, name), unrounded)
        refs[name] = sp1_reference(toks, check, unrounded, p)
        del module, grads_k, unrounded
        torch.cuda.empty_cache()
    return refs


def lm_training_phase(torch, fa):
    """The flagship LM trained through the port's CollectiveTrainer at
    bench_transformer.py's shape (see the module docstring, phase 11)."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    rng = np.random.RandomState(9)
    out = {"grad_check": lm_grad_phase(torch, fa, rng)}

    spec = load_model_spec("transformer", LM_PARAMS + ";remat=true")
    cfg = spec.config
    B, T = LM_TRAIN_BATCH, cfg.max_seq_len
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEVICE)
    tmp = tempfile.TemporaryDirectory()
    try:
        trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE)
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

        # Checkpoint round trip (LM_GRAD_LAYERS layers, trained a few
        # steps): parameters and AdamW moments in the JAX names and
        # layouts, restored bit for bit, the same next loss.
        del trainer
        torch.cuda.empty_cache()
        spec = load_model_spec("transformer",
                               lm_params_at(LM_GRAD_LAYERS) + ";remat=true")
        saver = CheckpointSaver(tmp.name)
        trainer = CollectiveTrainer(spec, batch_size=B, device=DEVICE,
                                    checkpoint_saver=saver)
        for _ in range(LM_PLAIN_STEPS):
            trainer.train_minibatch(tokens, tokens)
        trainer.save_checkpoint()
        trainer.flush_checkpoints()
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
        print("lm train: checkpoint of %d layers at version %d (%d mu + %d "
              "nu slots, embed's [%d, %d]) restored into a fresh trainer bit "
              "for bit; next loss %r on both" % (
                  LM_GRAD_LAYERS, saved_version, len(mu), len(mu),
                  cfg.vocab_size, cfg.dim, a))
        del restored, trainer
    finally:
        tmp.cleanup()
    torch.cuda.empty_cache()
    return out


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
    """Flagship-MoE at MOE_SERVE_LAYERS layers (MOE_SERVE_PARAMS, seeded
    random weights, bf16 compute)
    exported with ``export_generate`` (float32 weights, ~10 GB, into
    ``tmp``; the free space is printed first and a shortfall fails),
    served over HTTP with MOE_REQUESTS requests of LM_BATCH prompts (one
    B3 launch a layer each), and held against plain attention as the
    dense LM."""
    import shutil

    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec

    spec = load_model_spec("transformer", MOE_SERVE_PARAMS)
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
    served = endpoint._snapshot()[0].module
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
    del endpoint
    out["batched"] = batched_lm_leg(torch, fa, served, cfg, tmp, "moe", 12)
    del served
    torch.cuda.empty_cache()
    return out


def moe_training_phase(torch, fa):
    """Flagship-MoE at MOE_TRAIN_LAYERS layers trained at batch
    LM_TRAIN_BATCH x 2048, bf16 compute,
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
    spec = load_model_spec("transformer", MOE_TRAIN_PARAMS.replace(
        "dtype=bfloat16", "dtype=float32") + ";remat=true")
    cfg = spec.config
    module = spec.init_fn(DEVICE, seed=0)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, size=(LM_GRAD_BATCH, cfg.max_seq_len))).to(DEVICE)
    out["grad_check_f32"], grads_k, _ = lm_grads_vs_plain(
        torch, fa, spec, module, toks, "MoE f32 (TF32 off)")
    del grads_k, module
    torch.cuda.empty_cache()

    spec = load_model_spec("transformer", MOE_TRAIN_PARAMS + ";remat=true")
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
# At batch 2 (8 until phase 16's A18 legs needed the room: the two cases
# took 15.1 s of the sp=4 world on the H100, PERF.md §6, PR 21).
SP4_ATTENTION = [(23, "bfloat16", 2, 0), (24, "bfloat16", 2, 768)]
SP_TIMED_STEPS = 2              # 3 before phase 24 was added
# The multi-rank LM phases (16 and 20) run the flagship's widths at this
# depth (phase 11 trains all 24 layers in one process): every check stays,
# launch counts scale with the depth (B3p 2 L and 4 L a step on the sp=2
# ranks, B3/B4/B5 2 L/L/L), and ``multi_rank_refs`` computes the sp=1
# references at this depth (4 before phase 25 was added: on the slower
# hosts of its runs phases 16 and 20 took 173.5 and 59.9 s).
MULTI_RANK_LAYERS = 2
# A checkpoint saved at sp=2 and restored at sp=1: the loss, and the loss
# after one more step, within SP_LOSS_RTOL of the sp=2 trainer's.  The two
# paths' attention rounds differently in bf16: their step-1 losses on the
# same parameters sit 4.0e-6 apart on the H100, the restored ones 4.1e-7
# and 2.1e-6; 2e-5 is about 5x the largest.  A lost optimizer state or a
# wrong parameter moves the loss after the step by far more.
SP_LOSS_RTOL = 2e-5
SP_RANKS_TIMEOUT_S = 900
# Phase 16's A18 legs: tensor, pipeline and expert parallelism, run by the
# sp=2 world's two processes after its own legs, each over a mesh of its
# own, at MULTI_RANK_LAYERS layers (batch 8 x 2048, bf16, AdamW, remat)
# through the port's SPMDTrainer and the zoo entry's ``mesh=``:
# (name, mesh axes, ``multi_rank_refs`` key, pipeline microbatches).
# Their step-1 gradients are held as the sp=2 leg's are (``sp1_reference``).
A18_LEGS = (("pp=2", {"pp": 2}, "bf16", 4), ("tp=2", {"tp": 2}, "bf16", 0),
            ("ep=2", {"ep": 2}, "moe", 0))
A18_TIMED_STEPS = SP_TIMED_STEPS
# The tp=2 leg's checkpoint, restored with no mesh: the loss, and the loss
# after one more step, within TP_LOSS_RTOL of the tp=2 trainer's.  A row
# split rounds each rank's partial product to bf16 before the sum, where
# one process rounds the whole product once: on the H100 the two sat
# 5.8e-6 to 2.2e-5 apart (PERF.md §6, PR 21); 1e-4 is 4.5x the largest.
# A lost optimizer state or a wrong block moves the loss after the step
# by 1e-2 or more.
TP_LOSS_RTOL = 1e-4


def a18_launches(axes, microbatches, layers=MULTI_RANK_LAYERS):
    """(B3, B3p, B4, B5) a step a rank under remat: a pp stage holds
    layers / pp layers and runs each microbatch through them under one
    checkpoint (its forward and its recompute, B3 twice); tp and ep ranks
    run every layer on the whole batch (tp on half the heads)."""
    if axes.get("pp", 1) > 1:
        per = microbatches * layers // axes["pp"]
        return (2 * per, 0, per, per)
    return (2 * layers, 0, layers, layers)




def partial_phase(torch, fa):
    """B3p against ``_partial_ref`` at every PARTIAL_CHECKS shape (acc, l,
    m), bitwise across two runs at the ring's shapes; then, at
    PARTIAL_TIMED causal and non-causal in both dtypes, the kernel's time,
    the plain version's and the bound.  No PyTorch call returns the
    unnormalised acc; the nearest one call is
    ``aten._scaled_dot_product_flash_attention`` (bf16 only), whose
    normalised output and log-sum-exp carry the same information as
    (acc, l, m) with m = lse and l = 1: its time is the library time in
    bf16, none in float32."""
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
                   "library_ms": time_ms(
                       torch, lambda: torch.ops.aten.
                       _scaled_dot_product_flash_attention(
                           q, k, v, 0.0, causal, False, scale=D ** -0.5),
                       flush) if name == "bfloat16" else None}
            row.update(flash_bound(B, H, T, D, q.element_size(), causal, 0,
                                   "partial"))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            timed[(name, causal)] = row
            print("time flash_partial B=%d H=%d T=%d D=%d %s causal=%s: "
                  "kernel %.4f ms, plain %.4f ms, library (aten._scaled_dot_"
                  "product_flash_attention: out and lse) %s ms, bound %.4f "
                  "ms (%s; %.2f GFLOP, %.1f MB), %.1f %% of the bound" % (
                      B, H, T, D, name, causal, row["ms"], row["plain_ms"],
                      "none" if row["library_ms"] is None
                      else "%.4f" % row["library_ms"],
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

    t_leg = time.perf_counter()
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
    out["leg_s"] = time.perf_counter() - t_leg
    return out


def a18_model_leg(torch, fa, leg):
    """One A18 leg in a rank of phase 16's sp=2 world, over a mesh of its
    own (``leg["axes"]``): the zoo entry with ``mesh=`` (and
    ``pipeline_microbatches``) through the SPMD trainer from its seeded
    init, step 1 with its launches counted and its gradients (each block
    summed over the ranks that hold it, gathered whole) held by rank 0 leaf
    by leaf to the single process's dense f32 softmax path within the
    leaf's limit (``sp1_reference``); one counted step, timed steps (the
    loss must fall), and with ``leg["ckpt_dir"]`` a checkpoint."""
    from elasticdl_tpu_torch.models import transformer as tfm
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.spmd_trainer import (
        SPMDTrainer,
        gather_block,
    )
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    t_leg = time.perf_counter()
    mesh = build_mesh(**leg["axes"], backend="gloo")
    rank = torch.distributed.get_rank()
    extra = ({"pipeline_microbatches": leg["microbatches"]}
             if leg["microbatches"] else {})
    spec = load_model_spec("transformer", leg["params"], mesh=mesh, **extra)
    cfg = spec.config

    def loss_fn(module, batch):
        toks, = batch
        # Per-example means (+ the MoE aux): their sum over this rank's
        # rows, counted once per row.
        return (spec.loss_fn(spec.apply_fn(module, toks, True), toks).sum(),
                toks.shape[0])

    trainer = SPMDTrainer(mesh, spec.init_fn, loss_fn, spec.optimizer,
                          param_specs=tfm.param_specs(cfg))
    toks = torch.from_numpy(leg["tokens"]).long()
    batch = (toks,)
    want = leg["want"]
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
    grads = {n: gather_block(p.grad, trainer._specs[n], mesh)
             for n, p in trainer.module.named_parameters()}
    if rank == 0:
        ref = torch.load(leg["grads_path"])
        errs = {}
        for n, g in grads.items():
            if not bool(g.isfinite().all()):
                raise RuntimeError("%s: gradient of %s not finite"
                                   % (leg["name"], n))
            errs[n] = norm_rel(g, ref[n].to(g.device))
        del ref
        bad = [n for n in errs if not errs[n] <= leg["limit"][n]]
        if bad:
            raise RuntimeError(
                "%s: step-1 gradients of %s off the single process's dense "
                "f32 softmax path: %s (limits %s)" % (
                    leg["name"], bad[:5], [errs[n] for n in bad[:5]],
                    [leg["limit"][n] for n in bad[:5]]))
        if cfg.moe_experts:
            zero = [n for n in ("layers.w_router", "layers.w_gate",
                                "layers.w_down") if not float(
                                    grads[n].abs().max()) > 0]
            if zero:
                raise RuntimeError("%s: zero gradients for %s"
                                   % (leg["name"], zero))
        worst = max(errs, key=errs.get)
        out.update({"grad_rel_err_max": errs[worst],
                    "grad_rel_err_leaf": worst,
                    "err_over_limit_max": max(errs[n] / leg["limit"][n]
                                              for n in errs)})
    del grads
    torch.cuda.synchronize()
    sp_zero_counts(fa)
    counted = float(trainer.train_step(batch))
    torch.cuda.synchronize()
    counts = sp_counts(fa)
    if counts != want:
        raise RuntimeError("%s rank %d: a training step launched (B3, B3p, "
                           "B4, B5) %s, want %s" % (leg["name"], rank,
                                                    counts, want))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch) for _ in range(A18_TIMED_STEPS)]
    losses = [float(x) for x in losses]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / A18_TIMED_STEPS
    if not all(map(math.isfinite, losses)) or not losses[-1] < counted:
        raise RuntimeError("%s: the loss did not fall: %s" % (
            leg["name"], [counted] + losses))
    out.update({"launches_per_step": counts, "losses": [counted] + losses,
                "ms_per_step": ms,
                # The step's whole batch: every rank of these meshes runs
                # the same rows.
                "tokens_per_s": toks.numel() / ms * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    if leg["ckpt_dir"]:
        t0 = time.perf_counter()
        trainer.save_checkpoint(CheckpointSaver(leg["ckpt_dir"]))
        out["save_s"] = time.perf_counter() - t0
        version, loss = trainer.version, float(trainer.eval_loss(batch))
        trainer.train_step(batch)
        out["saved"] = (version, loss, float(trainer.eval_loss(batch)))
    del trainer
    torch.cuda.empty_cache()
    out["leg_s"] = time.perf_counter() - t_leg
    return out


def sp_rank(sp, attention, legs, a18_legs=()):
    """One rank of an ``sp`` world on the card (gloo groups, host-staged
    transport): the ring attention cases, then the model legs, then the
    A18 legs over meshes of their own."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.ring_attention import ring_attention
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    entered = time.time()
    use_float32_numerics()
    mesh = build_mesh(sp=sp, backend="gloo")
    rank, tl = mesh.coords["sp"], SP_ATTENTION_T // sp
    out = {"rank": rank, "device": str(mesh.device), "attention": [],
           "entered_at": entered}
    t0 = time.perf_counter()
    for seed, name, batch, window in attention:
        q, k, v, g = (t[:, rank * tl:(rank + 1) * tl]
                      for t in sp_inputs(torch, seed, name, batch))
        leaves = [t.contiguous().requires_grad_() for t in (q, k, v)]
        o = ring_attention(*leaves, mesh, causal=True, window=window)
        o.backward(g)
        out["attention"].append([o.detach().cpu()]
                                + [t.grad.cpu() for t in leaves])
        del q, k, v, g, leaves, o
    out["attention_s"] = time.perf_counter() - t0
    out["legs"] = [sp_model_leg(torch, fa, mesh, leg) for leg in legs]
    out["a18"] = [a18_model_leg(torch, fa, leg) for leg in a18_legs]
    return out


def sp_spawn(sp, attention, legs, a18_legs=()):
    from elasticdl_tpu_torch.parallel import launch

    try:
        return launch.spawn(sp_rank, sp, (sp, attention, legs, a18_legs),
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


def a18_leg(name, axes, ref, microbatches, tmp, ckpt_dir):
    """An A18 leg's arguments, the single process's gradients saved for
    rank 0."""
    import torch

    path = os.path.join(tmp, "a18 %s.pt" % name)
    torch.save(ref["grads"], path)
    return {"name": name, "axes": axes, "params": ref["params"],
            "microbatches": microbatches, "tokens": ref["tokens"],
            "limit": ref["limit"], "grads_path": path,
            "want": a18_launches(axes, microbatches), "ckpt_dir": ckpt_dir}


def a18_report(torch, lm_refs, legs, ranks, ckpt_dir):
    """Print phase 16's A18 legs (each rank's readings, the card's name and
    power limit beside them) and hold the tp=2 checkpoint: restored with
    no mesh in this process, the same loss before and after one more
    step (TP_LOSS_RTOL)."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    smi = nvidia_smi_line()
    out = []
    for i, leg in enumerate(legs):
        got = [r["a18"][i] for r in ranks]
        ref = lm_refs[[k for n, _, k, _ in A18_LEGS if n == leg["name"]][0]]
        for r in got:
            r["step1_loss_rel_gap"] = abs(
                r["step1_loss"] - ref["loss"]) / abs(ref["loss"])
        print("A18 %s (%s; flagship widths, %d layers, batch %d x %d, bf16, "
              "AdamW, remat; %s): step-1 loss %.6f (single process %.6f, gap "
              "%.3g relative); gradients against its dense f32 softmax path: "
              "worst leaf %s %.3g norm-relative, %.3g of its limit; launches "
              "a step a rank (B3, B3p, B4, B5) %s; loss %s over %d steps; ms "
              "a step %s, %.0f tokens/s, peak allocated %s GB a rank; leg %s "
              "s" % (leg["name"], leg["axes"], MULTI_RANK_LAYERS,
                     *leg["tokens"].shape, smi, got[0]["step1_loss"],
                     ref["loss"], got[0]["step1_loss_rel_gap"],
                     got[0]["grad_rel_err_leaf"], got[0]["grad_rel_err_max"],
                     got[0]["err_over_limit_max"],
                     [r["launches_per_step"] for r in got],
                     " -> ".join("%.4f" % x for x in got[0]["losses"]),
                     A18_TIMED_STEPS + 1,
                     ", ".join("%.2f" % r["ms_per_step"] for r in got),
                     got[0]["tokens_per_s"],
                     ", ".join("%.2f" % r["peak_gb"] for r in got),
                     ", ".join("%.1f" % r["leg_s"] for r in got)))
        out.append(got)
    tp = [got for got in out if got[0]["name"] == "tp=2"][0][0]
    spec = load_model_spec("transformer", lm_refs["bf16"]["params"])
    toks = torch.from_numpy(lm_refs["bf16"]["tokens"]).to(DEVICE)
    version, loss2, next2 = tp["saved"]
    restored = CollectiveTrainer(spec, batch_size=toks.shape[0],
                                 device=DEVICE,
                                 checkpoint_saver=CheckpointSaver(ckpt_dir))
    if not restored.init_from_checkpoint() or restored.version != version:
        fail("the tp=2 checkpoint did not restore with no mesh")

    def loss_now():
        with torch.no_grad():
            return float(spec.loss_fn(spec.apply_fn(
                restored.module, toks, True), toks).mean())

    loss1 = loss_now()
    restored.train_minibatch(toks, toks)
    next1 = loss_now()
    gaps = (abs(loss1 - loss2) / abs(loss2), abs(next1 - next2) / abs(next2))
    if not max(gaps) <= TP_LOSS_RTOL:
        fail("checkpoint saved at tp=2 (version %d), restored with no mesh: "
             "loss %r vs %r, next step %r vs %r (limit %g relative)"
             % (version, loss1, loss2, next1, next2, TP_LOSS_RTOL))
    print("A18 checkpoint saved at tp=2 (version %d, gathered and written in "
          "%.2f s) restored with no mesh: loss %.6f vs %.6f, next step %.6f "
          "vs %.6f (gaps %.3g, %.3g relative, limit %g)" % (
              version, tp["save_s"], loss1, loss2, next1, next2, gaps[0],
              gaps[1], TP_LOSS_RTOL))
    del restored
    torch.cuda.empty_cache()
    return {"legs": out, "checkpoint": {
        "version": version, "tp2": [loss2, next2], "no_mesh": [loss1, next1],
        "rel_gaps": gaps}}


def a18_launch_counts(sp, i):
    """{A18 leg: [launches of (B3, B3p, B4, B5)[i] in its counted step, a
    rank]} from ``sp_phase``'s readings."""
    return {got[0]["name"]: [r["launches_per_step"][i] for r in got]
            for got in sp["a18"]["legs"]}


def sp_phase(torch, fa, lm_refs, beside=None):
    """Sequence parallelism on the card (module docstring, phase 16);
    ``lm_refs``: ``multi_rank_refs``.  ``beside`` (a ``Beside``) starts
    once the kernel timings are done, to run beside the worlds."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    out = {}
    t0 = time.perf_counter()
    out["partial_worst"], out["partial_max_abs_err"], out["partial_timed"] = (
        partial_phase(torch, fa))
    out["partial_s"] = time.perf_counter() - t0
    if beside is not None:
        beside.start()

    toks = torch.from_numpy(lm_refs["bf16"]["tokens"]).to(DEVICE)
    tmp = tempfile.TemporaryDirectory()
    try:
        ckpt_dir = os.path.join(tmp.name, "ckpt")
        a18_dir = os.path.join(tmp.name, "a18 ckpt")
        a18 = [a18_leg(name, axes, lm_refs[key], mb, tmp.name,
                       a18_dir if name == "tp=2" else None)
               for name, axes, key, mb in A18_LEGS]
        worlds = {}
        for sp, cases, leg_refs in (
                (2, SP2_ATTENTION, [("f32 batch 2", lm_refs["f32"], False),
                                    ("bf16 batch 8", lm_refs["bf16"], True)]),
                (4, SP4_ATTENTION, [("bf16 batch 8", lm_refs["bf16"],
                                     False)])):
            legs = [sp_leg(name, ref, tmp.name, train, ckpt_dir)
                    for name, ref, train in leg_refs]
            refs = [sp_attention_reference(torch, fa, c) for c in cases]
            t0, spawned = time.perf_counter(), time.time()
            ranks = sp_spawn(sp, cases, legs, a18 if sp == 2 else ())
            out["sp%d_s" % sp] = time.perf_counter() - t0
            print("sp=%d world: %.1f s; rank 0 entered %.1f s after the "
                  "spawn, its attention cases %.1f s, its legs %s s" % (
                      sp, out["sp%d_s" % sp],
                      ranks[0]["entered_at"] - spawned,
                      ranks[0]["attention_s"],
                      ", ".join("%.1f" % r["leg_s"]
                                for r in ranks[0]["legs"])), flush=True)
            if sp == 2:
                out["a18"] = a18_report(torch, lm_refs, a18, ranks, a18_dir)
                out["a18_s"] = sum(got[0]["leg_s"]
                                   for got in out["a18"]["legs"])
                print("phase 16, A18 legs: %.1f s of the sp=2 world's %.1f s "
                      "(rank 0's legs)" % (out["a18_s"], out["sp2_s"]),
                      flush=True)
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


# The master/worker process path (phase 17).  Leg 1: the flagship's widths
# at MULTI_RANK_LAYERS layers (remat; at its full 24 layers until the
# depth was cut to make room for phase 24) trained in this process
# through the port's master (TaskManager + gRPC servicer) and Worker task
# loop, PROC_TASKS
# tasks of PROC_MINIBATCHES minibatches at batch LM_TRAIN_BATCH x 2048
# (synthetic_lm: arithmetic token sequences), PROC_JOBS such jobs in
# turn with PROC_DIRECT_STEPS direct CollectiveTrainer steps on one batch
# before, between and after them, for the task loop's overhead.  Leg 2: the master CLI with 2 worker processes on the
# card, the flagship's widths at CLI_LAYERS layers (100.7 M parameters,
# a 1.21 GB checkpoint of parameters and AdamW moments), worker 0
# killed -9 after its first checkpoint; both workers start from an empty
# kernel cache (ELASTICDL_TORCH_BUILD_DIR): each starts every build in the
# background as it starts, one compiles each source while the other waits
# for it (ops/build.py's lock), and the replacement loads the cached
# libraries.
PROC_MINIBATCHES = 4
PROC_TASKS = 4
PROC_DIRECT_STEPS = 5
PROC_JOBS = 2
CLI_LAYERS = 4
CLI_PARAMS = ("vocab_size=32768;dim=1024;num_heads=16;num_layers=%d;"
              "seq_len=2048;dtype=bfloat16;remat=true" % CLI_LAYERS)
# 160 tasks of 4 minibatches: enough that the surviving worker cannot
# finish the job before the replacement's first step (96 were not: on an
# H100 80GB HBM3, 700 W, the survivor once ran all of them before it).
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
    spec = load_model_spec("transformer", LM_PARAMS.replace(
        "num_layers=%d" % LM_LAYERS, "num_layers=%d" % MULTI_RANK_LAYERS)
        + ";remat=true")
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
    """The master CLI (or ``module``, another entry point that runs it) as
    a subprocess; a thread stamps each log line with the host clock as it
    arrives.  ``what`` names the leg in failures."""

    def __init__(self, args, env, cwd, what="process path, leg 2",
                 module="elasticdl_tpu_torch.master.main"):
        self.what = what
        self.lines = []
        self._cond = threading.Condition()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module] + args,
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

    def worker_pids(self):
        """{pid: worker id} of the master's children that run a worker.
        The children file lists the workers' threads too (a thread's
        parent is its process's): only thread-group leaders count."""
        out = {}
        for pid in self.children():
            try:
                if _tgid(pid) != pid:
                    continue
                with open("/proc/%d/environ" % pid, "rb") as f:
                    env = f.read().split(b"\0")
            except OSError:
                continue
            for item in env:
                if item.startswith(b"WORKER_ID="):
                    out[pid] = int(item[len(b"WORKER_ID="):])
        return out

    def worker_pid(self, worker_id):
        for pid, wid in self.worker_pids().items():
            if wid == worker_id:
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


# -- the killed-master drill harness ---------------------------------------
#
# The killed-master drill on port processes (counterpart of the JAX
# package's ``bench_elastic.run_master_kill_drill``), run by phase 17's
# leg 3 on the card and by tests/test_torch_master_recovery.py on the CPU.
#
# A first master (``python -m elasticdl_tpu_torch.master.main``) launches
# process workers and journals the job (``--journal_dir``).  Once a few
# training tasks are done the master is SIGKILLed: the workers are
# orphaned, and their outage-riding clients (``utils/retry.py``) keep
# retrying against the master's fixed port.  A second master starts with
# ``--num_workers 0`` on the same port: it replays the journal, requeues
# the tasks that were in flight, and the same worker processes reconnect
# without a restart and finish the job.  The drill measures the recovery
# time (kill -> the first task completed after the restart, read from the
# live journal) and checks the accounting: every training task completed
# exactly once (a doubled one would overshoot, a lost one would hang or
# undershoot), none failed, the second master exits 0 and launched no
# worker, and the workers that finished the job are the first master's
# (their pids alive at the recovery).  Which orphans exited by themselves
# and wrote their trace dumps is reported: an idle one that asks again
# only after the job has ended rides its outage budget out, and is reaped
# once the others have exited and a grace has passed, as the JAX drill
# reaps its orphans.
#
# Trace gate: every process runs with ``$ELASTICDL_TRACE_DIR`` set; the
# survivors' flight-recorder dumps and the restarted master's stitch into
# one connected trace holding the workers' ``rpc_retry`` events in the
# outage, the second master's ``journal.replayed`` (inside its
# ``master.journal_replay`` span, linked to by every later event of it)
# and a task completed after the restart (``task.completed`` with
# ``restart`` set).
#
# ``run_master_kill_drill`` returns a dict of what it saw; the caller
# gates on it (``tests/test_torch_master_recovery.py`` on the CPU,
# ``chip_smoke.py`` on the card).  Every process it starts is stopped
# before it returns.


DRILL_MASTER_MODULE = "elasticdl_tpu_torch.master.main"
DRILL_WORKERS = 2
# Training tasks journaled done before the kill.
DRILL_KILL_AFTER_TASKS = 3
DRILL_POLL_S = 0.25
# After the restarted master's exit: how long the orphans get once one of
# them has exited (the JAX drill waits 10 s for its dumps), and how long
# past its outage budget the first may take (a loaded host's teardown).
DRILL_EXIT_GRACE_S = 10
DRILL_EXIT_MARGIN_S = 30


def _drill_worker_pids(master_pid):
    """{pid: worker id} of the master's children that run a worker (a
    thread listed in the children file is not a process of its own)."""
    path = "/proc/%d/task/%d/children" % (master_pid, master_pid)
    try:
        with open(path) as f:
            children = [int(p) for p in f.read().split()]
    except OSError:
        return {}
    out = {}
    for pid in children:
        try:
            with open("/proc/%d/status" % pid) as f:
                tgid = int(re.search(r"^Tgid:\s*(\d+)", f.read(),
                                     re.M).group(1))
            if tgid != pid:
                continue
            with open("/proc/%d/environ" % pid, "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        for item in env:
            if item.startswith(b"WORKER_ID="):
                out[pid] = int(item[len(b"WORKER_ID="):])
    return out


def _alive(pid):
    """Whether ``pid`` runs (an orphan is not this process's child, so
    its exit is read from /proc: a zombie counts as gone)."""
    try:
        with open("/proc/%d/status" % pid) as f:
            return not re.search(r"^State:\s*Z", f.read(), re.M)
    except OSError:
        return False


def _drill_trace_connected(events):
    """Whether one connected component of the dumps holds the workers'
    ``rpc_retry``, the restarted master's ``journal.replayed`` and a task
    completed after the restart."""
    from elasticdl_tpu_torch.utils import tracing

    for component in tracing.trace_components(events):
        names = {e["name"] for e in component}
        if {"rpc_retry", "journal.replayed", "task.completed"} <= names and \
                any(e.get("restart") for e in component
                    if e["name"] == "task.completed"):
            return True
    return False


def run_master_kill_drill(master_args, env=None, cwd=None,
                          rpc_deadline_secs=45, deadline_secs=240.0):
    """Run the drill on a job of ``master_args`` (the master CLI's flags
    without ``--journal_dir``, ``--port`` and ``--num_workers``):
    DRILL_WORKERS process workers, the kill once DRILL_KILL_AFTER_TASKS
    training tasks are journaled done.  ``env`` is the processes' environment (the
    CPU or the card is its choice), ``deadline_secs`` bounds each of the
    two masters' waits, ``rpc_deadline_secs`` is how long an orphaned
    worker rides the outage.
    Returns {expected and completed tasks, failed tasks, restarts,
    seconds (kill -> recovery, the whole drill), worker pids before and
    at recovery, exit codes, the two masters' logs, the trace gate}."""
    from elasticdl_tpu_torch.master.journal import replay_journal
    from elasticdl_tpu_torch.proto import elastic_pb2 as pb
    from elasticdl_tpu_torch.utils import tracing
    from elasticdl_tpu_torch.utils.grpc_utils import find_free_port

    tmp = tempfile.mkdtemp(prefix="edl-master-kill-")
    jdir = os.path.join(tmp, "journal")
    tdir = os.path.join(tmp, "traces")
    port = find_free_port()
    env = dict(os.environ if env is None else env)
    env["ELASTICDL_RPC_DEADLINE_SECS"] = str(rpc_deadline_secs)
    env["ELASTICDL_TRACE_DIR"] = tdir
    base = ([sys.executable, "-m", DRILL_MASTER_MODULE] + list(master_args)
            + ["--journal_dir", jdir, "--port", str(port)])
    logs = [os.path.join(tmp, "master%d.log" % i) for i in (1, 2)]

    def completed():
        state = replay_journal(jdir)
        return 0 if state is None else state.completed_counts.get(
            int(pb.TRAINING), 0)

    def start(log, workers):
        with open(log, "w") as f:
            # The workers inherit the master's stderr: the first
            # master's log goes on collecting theirs after the kill.
            return subprocess.Popen(
                base + ["--num_workers", str(workers)], env=env, cwd=cwd,
                stdout=subprocess.DEVNULL, stderr=f)

    out = {"port": port}
    masters, pids = [], {}
    # The journal is read every poll: its replay's log line stays quiet.
    journal_log = logging.getLogger(replay_journal.__module__)
    level = journal_log.level
    journal_log.setLevel(logging.WARNING)
    t0 = time.perf_counter()
    try:
        masters.append(start(logs[0], DRILL_WORKERS))
        deadline = time.monotonic() + deadline_secs
        while completed() < DRILL_KILL_AFTER_TASKS:
            if masters[0].poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(
                    "the first master (rc %s) journaled %d of %d tasks "
                    "done before the kill was due:\n%s" % (
                        masters[0].poll(), completed(), DRILL_KILL_AFTER_TASKS,
                        _file_tail(logs[0])))
            pids.update(_drill_worker_pids(masters[0].pid))
            time.sleep(DRILL_POLL_S)
        pids.update(_drill_worker_pids(masters[0].pid))
        t_kill = time.perf_counter()
        masters[0].send_signal(signal.SIGKILL)
        masters[0].wait(timeout=30)
        # Read once the master is dead: the journal is final, so any
        # later completion is the second master's.
        out["tasks_done_at_kill"] = done_at_kill = completed()
        out["kill_at_s"] = t_kill - t0
        out["worker_pids"] = {w: pid for pid, w in sorted(pids.items())}
        masters.append(start(logs[1], 0))
        recovery = None
        deadline = time.monotonic() + deadline_secs
        while masters[1].poll() is None and time.monotonic() < deadline:
            if recovery is None and completed() > done_at_kill:
                recovery = time.perf_counter() - t_kill
                out["pids_alive_at_recovery"] = {
                    w: _alive(pid) for pid, w in pids.items()}
            time.sleep(DRILL_POLL_S)
        if masters[1].poll() is None:
            out["error"] = "the restarted master did not finish in time"
        out["recovery_s"] = recovery
        out["drill_s"] = time.perf_counter() - t0
        out["master2_rc"] = masters[1].poll()
        state = replay_journal(jdir)
        out["tasks_completed"] = state.completed_counts.get(
            int(pb.TRAINING), 0)
        out["tasks_failed"] = sum(state.failed_counts.values())
        out["restarts"] = state.restarts
        # The orphans exit (and dump their traces) once the second
        # master has said the job is done, or once their outage budget
        # runs out if they ask again only after it has ended.  Once one
        # has exited the others get DRILL_EXIT_GRACE_S; the rest are reaped
        # below, as the JAX drill reaps its orphans (its trace gate needs
        # one worker's dump beside the master's).
        now = time.monotonic()
        deadline = now + rpc_deadline_secs + DRILL_EXIT_MARGIN_S
        grace_end = now + DRILL_EXIT_GRACE_S
        while True:
            living = [p for p in pids if _alive(p)]
            now = time.monotonic()
            if not living or now > deadline or (
                    len(living) < len(pids) and now > grace_end):
                break
            time.sleep(DRILL_POLL_S)
        out["workers_exited"] = not any(_alive(p) for p in pids)
        dumps = sorted(os.listdir(tdir)) if os.path.isdir(tdir) else []
        out["worker_dumps"] = {
            w: "worker-%d.trace.json" % pid in dumps
            for pid, w in pids.items()}
        events = tracing.load_dumps(tdir)
        out["trace_events"] = len(events)
        out["trace_connected"] = _drill_trace_connected(events)
    finally:
        journal_log.setLevel(level)
        for proc in masters:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        for pid in pids:
            if _alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        out["logs"] = [_read_file(log) for log in logs]
        shutil.rmtree(tmp, ignore_errors=True)
    out["master2_launched"] = len(re.findall(r"launched worker \d+",
                                             out["logs"][1]))
    return out


def _read_file(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _file_tail(path, n=40):
    return "".join(_read_file(path).splitlines(True)[-n:])


# The killed-master drill (phase 17, leg 3; ROADMAP A4c): the port's twin
# of bench_elastic.py's run_master_kill_drill (run_master_kill_drill
# above) on a resnet50_cifar10 job
# (the ResNet-50 stages at full width on 32x32 synthetic_cifar10) of two
# process workers on the card, journaled.  The master is SIGKILLed once
# 3 training tasks are journaled done and restarted with
# --num_workers 0 on the same port; the same two worker processes ride
# the outage and finish the job.  Gates: every task completed once and
# none failed, one restart, the second master exits 0 having launched no
# worker, the first master's worker pids alive at the first task after
# the restart, one connected trace (the workers' rpc_retry, the restarted
# master's journal.replayed, a task completed after the restart), and B1
# and B2 53 launches a pass in each worker that logged its launches at
# its exit, one at least (an orphan still riding its outage budget past
# the job's end is reaped, as the JAX drill reaps its orphans).
# 16 tasks (32 before: a size cut), the kill after 3.
DRILL_RECORDS = 2048
DRILL_BATCH = 32
# How long an orphaned worker rides an outage: the restart, a process that
# imports torch, took 9.9-17.0 s to its first task when the drill ran
# alone (PERF.md §6), and it runs beside phase 16's worlds; a worker that
# asks again only after the restarted master has ended the job gives up
# after it (and then logs its launches and exits), and is reaped once the
# other has exited and the drill's grace has passed.  The JAX drill's
# budget.
DRILL_RPC_DEADLINE_S = 45


def _worker_env():
    """The environment of a CLI job's workers on the card: the device
    variable unset (their default: cuda), the build phase's libraries
    (the workers load, never build), the checkout on the path."""
    from elasticdl_tpu_torch.ops import build

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("ELASTICDL_TORCH_DEVICE", None)
    env["ELASTICDL_TORCH_BUILD_DIR"] = build.BUILD_DIR
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _logged_launches(log, worker_id, what):
    m = re.search(r"\[worker-%d\] .*kernel launches: (\{.*\})"
                  % worker_id, log)
    if not m:
        fail("%s: worker %d logged no kernel launches" % (what, worker_id))
    return json.loads(m.group(1))


def master_kill_leg(torch):
    what = "process path, leg 3 (killed master)"
    tmp = tempfile.TemporaryDirectory()
    try:
        out = run_master_kill_drill(
            ["--model_zoo", "resnet", "--model_params",
             "variant=resnet50_cifar10", "--data_origin",
             "synthetic_cifar10:%d" % DRILL_RECORDS,
             "--batch_size", str(DRILL_BATCH),
             "--num_minibatches_per_task", "4", "--num_epochs", "1"],
            env=_worker_env(), cwd=tmp.name,
            rpc_deadline_secs=DRILL_RPC_DEADLINE_S)
    finally:
        tmp.cleanup()
    logs = out.pop("logs")
    tasks = DRILL_RECORDS // (DRILL_BATCH * 4)
    on_card = sorted(set(re.findall(r"worker (\d+) training on (\S+)",
                                    logs[0])))
    # A worker logs its launches at its exit; an orphan reaped after its
    # outage budget (the drill harness above) logs none.
    launches = {}
    for w in (0, 1):
        m = re.search(r"\[worker-%d\] .*kernel launches: (\{.*\})" % w,
                      logs[0])
        if m:
            launches[w] = json.loads(m.group(1))
    checks = {
        "every task completed once": out["tasks_completed"] == tasks,
        "none failed": out["tasks_failed"] == 0,
        "one restart": out["restarts"] == 1,
        "the restarted master exits 0": out["master2_rc"] == 0,
        "it launched no worker": out["master2_launched"] == 0,
        "the same worker processes": out.get("pids_alive_at_recovery")
        == {0: True, 1: True},
        "one connected trace": out["trace_connected"],
        "workers on the card": [w for w, _ in on_card] == ["0", "1"]
        and all(d.startswith("cuda") for _, d in on_card),
        "B1/B2 %d a pass" % GN_PER_FORWARD: bool(launches) and all(
            c["train_passes"] > 0 and c["group_norm_fwd"]
            == c["group_norm_bwd"] == GN_PER_FORWARD * c["train_passes"]
            for c in launches.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad or "error" in out:
        fail("%s: %s %s; the restarted master's tail:\n%s" % (
            what, bad, out.get("error", ""),
            "".join(logs[1].splitlines(True)[-30:])))
    out["launches"] = launches
    out["tasks_expected"] = tasks
    out["checks"] = sorted(checks)
    print("%s (resnet50_cifar10, 2 process workers on the card, %d "
          "records, batch %d): SIGKILL at %.1f s with %d of %d tasks done; "
          "kill -9 -> the first task after the restart %.2f s; %d "
          "completed, 0 failed, restarts %d, the restarted master exit %d "
          "launching none; workers %s rode it (pids alive), exited by "
          "themselves: %s; trace %d events, connected; B1/B2 by worker %s; "
          "drill %.1f s" % (
              what, DRILL_RECORDS, DRILL_BATCH, out["kill_at_s"],
              out["tasks_done_at_kill"], tasks, out["recovery_s"],
              out["tasks_completed"], out["restarts"], out["master2_rc"],
              out["worker_pids"], out["workers_exited"], out["trace_events"],
              {w: (c["group_norm_fwd"], c["group_norm_bwd"])
               for w, c in launches.items()}, out["drill_s"]))
    return out


class Beside:
    """A leg run on a thread of its own beside a later phase, to make
    room in the script's time limit: its gates read nothing that the
    other's load can move (no time, no race against a survivor).
    ``start`` launches it; ``result`` waits for it and returns its
    output, or raises what it raised (``fail``'s exit included)."""

    def __init__(self, fn, *args):
        self._fn, self._args = fn, args
        self._thread, self._out, self._error = None, None, None
        self.seconds = None

    def start(self):
        t0 = time.perf_counter()

        def main():
            try:
                self._out = self._fn(*self._args)
            except BaseException as e:  # noqa: BLE001 — raised in result()
                self._error = e
            self.seconds = time.perf_counter() - t0

        # Not a daemon: if another phase fails meanwhile, the interpreter
        # waits for the leg at exit, and the leg stops what it started.
        self._thread = threading.Thread(target=main)
        self._thread.start()

    def result(self):
        if self._thread is None:
            self.start()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._out


def process_phase(torch, fa, master_kill):
    """Legs 1 and 2; leg 3 (``master_kill``, a ``Beside``) ran beside
    phase 16's worlds and is waited for first, so nothing of it runs
    beside legs 1 and 2."""
    drill = master_kill.result()
    print("process path, leg 3 (killed master) ran beside phase 16: %.1f s"
          % master_kill.seconds, flush=True)
    return {"in_process": process_leg(torch, fa), "cli": cli_leg(torch),
            "master_kill": drill}


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
COLL_CLI_KILL_STEPS = 4         # 8 before phase 25 was added
# Records enough that the survivor, alone, cannot finish them before the
# replacement joins, and few enough that the regrown world ends the job
# soon.  On an H100 (80GB HBM3, 700 W) the survivor took 13,440-16,128
# records alone (14-25 steps/s for the 23-37 s the replacement took to
# join) in the phase 18 and 19 jobs of six whole runs, and the regrown
# world ran 88-168 steps of 64 records to the end at 1.8-3.9 steps/s
# (PERF.md §6).  17,664 records (24,576 before phase 24 was added,
# 20,480 before phase 25, 18,432 before phase 16's A18 legs) leave the
# survivor 1.06x its largest take, after the 4 + 4 steps of the world of
# 2 before the kill, and the regrown world ~48 steps at the takes seen
# most.
COLL_CLI_RECORDS = 17664
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
    records = COLL_CLI_RECORDS
    tmp = tempfile.TemporaryDirectory()
    env = _worker_env()
    args = ["--model_zoo", "resnet", "--model_params",
            "variant=resnet50_cifar10",
            "--data_origin", "synthetic_cifar10:%d" % records,
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
    out = {"batch": COLL_CLI_BATCH, "records": records,
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
              what, COLL_CLI_BATCH, records, out["world2_at_s"],
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
# The A4c mesh leg (ROADMAP A4c): the two ranks of leg 1's last world
# re-formed under elastic_mesh_builder(tp=2), a mesh of dp=1 and tp=2:
# both replicas step on the same COLL_BATCH rows (drawn from this seed),
# and each step is held against trainers alone from the same state
# (parameters and the whole optimizer state) on those rows, one in each
# replica's process: the loss within COLL_LOSS_RTOL of this process's,
# every gradient leaf of the two processes' mean (what the world's sum
# computes) within phase 18's limit, COLL_FLOOR_X x its floor and
# COLL_GRAD_MIN at least, its floor the distance between the two steps
# alone (rank 0 runs leg 1's deterministic cuDNN algorithms, the joiner
# the defaults; on an H100 80GB HBM3, 700 W, the defaults' gradients
# moved up to 1.7e-5 of norm from run to run); then the data mesh
# again.
MESH_ROWS_SEED = 1919


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
    out["mesh"] = mesh_leg(torch, z, spec, {0: 0, 2: 1}[rank], epochs[3:])
    tdist.reset_single_process()
    return out


def mesh_leg(torch, z, spec, world_rank, epochs):
    """The A4c mesh leg of phase 19 (see MESH_ROWS_SEED), on one of the
    two ranks of its last world: the trainer ``z`` (ZeRO-1 on) re-formed
    under ``elastic_mesh_builder(tp=2)``, a step on the rows both ranks
    share, against a trainer alone from the same state; then the data
    mesh again and a step on this rank's own rows."""
    from elasticdl_tpu_torch.ops import group_norm as gn
    from elasticdl_tpu_torch.parallel import distributed as tdist
    from elasticdl_tpu_torch.parallel import transport
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    # No cuDNN setting of its own: rank 0 runs on leg 1's deterministic
    # algorithms, the joiner on the defaults, and the trainer's step over
    # the whole world keeps the two replicas one state all the same.
    rng = np.random.RandomState(MESH_ROWS_SEED)
    x = rng.rand(COLL_BATCH, COLL_IMAGE, COLL_IMAGE, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=COLL_BATCH).astype(np.int32)
    out = {}
    z.snapshot_to_host()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = tdist.elastic_mesh_builder(tp=2, device=DEVICE, timeout_secs=(
        COLL_RANKS_TIMEOUT_S))(world_rank, 2, epochs[0])
    z.rebuild(mesh)
    torch.cuda.synchronize()
    out["form_s"] = time.perf_counter() - t0
    out["shape"] = dict(mesh.shape)
    out["report"] = z.zero1_report()
    ref = CollectiveTrainer(spec, batch_size=COLL_BATCH, device=DEVICE)
    ref.module.load_state_dict(z.module.state_dict())
    ref._load_whole_state(z._whole_state())
    torch.cuda.synchronize()
    gn.LAUNCHES = gn.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    out["loss"] = float(z.train_minibatch(x, y)[0])
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = (gn.LAUNCHES, gn.BWD_LAUNCHES)
    out["loss_alone"] = float(ref.train_minibatch(x, y)[0])
    # The world's step is the mean of the replicas' steps, each computed
    # on its own process's cuDNN algorithms: it is held against the mean
    # of the two steps alone, each leaf within COLL_FLOOR_X x its floor,
    # the distance between the two steps alone (COLL_GRAD_MIN at least),
    # as phase 18 holds its steps; its gap to this rank's own is reported.
    own = {n: p.grad for n, p in ref.module.named_parameters()}
    both = {n: g.clone() for n, g in own.items()}
    transport.all_reduce_sum_(list(both.values()), mesh.group())
    got = dict(z.module.named_parameters())
    errs = {n: norm_rel(got[n].grad, g / 2) for n, g in both.items()}
    floor = {n: norm_rel(g - own[n], own[n]) for n, g in both.items()}
    out["grad_rel_err"] = max(errs.values())
    out["grad_floor_max"] = max(floor.values())
    out["grad_over_limit_max"] = max(
        errs[n] / max(COLL_GRAD_MIN, COLL_FLOOR_X * floor[n]) for n in errs)
    out["grad_rel_err_own"] = max(norm_rel(got[n].grad, g)
                                  for n, g in own.items())
    out["state"] = _state_print(torch, z)
    out["bitwise_alone"] = _state_print(torch, ref)[:2] == out["state"][:2]
    del ref, own, both, got
    torch.cuda.empty_cache()
    z.snapshot_to_host()
    t0 = time.perf_counter()
    z.rebuild(tdist.data_mesh_builder(DEVICE, COLL_RANKS_TIMEOUT_S)(
        world_rank, 2, epochs[1]))
    torch.cuda.synchronize()
    out["back_s"] = time.perf_counter() - t0
    out["report_back"] = z.zero1_report()
    own = np.random.RandomState(MESH_ROWS_SEED + 1 + world_rank)
    out["loss_back"] = float(z.train_minibatch(
        own.rand(*x.shape).astype(np.float32),
        own.randint(0, 1000, size=COLL_BATCH).astype(np.int32))[0])
    out["state_back"] = _state_print(torch, z)
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
            for _ in range(5)]
    epochs = [svc.start_epoch(n)
              for svc, n in zip(svcs, (2, 3, 2, 2, 2))]
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
    m0, m1 = r0["mesh"], joiner["mesh"]
    checks.update({
        "A4c: a (dp=1, tp=2) mesh": m0["shape"] == m1["shape"] == {
            "dp": 1, "pp": 1, "ep": 1, "tp": 2, "sp": 1},
        "A4c: one loss, both states bitwise": m0["loss"] == m1["loss"]
        and m0["state"][:2] == m1["state"][:2],
        "A4c: the step within the floors of the steps alone": all(
            abs(m["loss"] - m["loss_alone"]) <= COLL_LOSS_RTOL * abs(
                m["loss_alone"]) and m["grad_over_limit_max"] <= 1.0
            for m in (m0, m1)),
        "A4c: B1/B2 %d in the step" % GN_PER_FORWARD: all(
            tuple(m["launches"]) == (GN_PER_FORWARD, GN_PER_FORWARD)
            for m in (m0, m1)),
        "A4c: ZeRO-1 over dp alone": m0["report"]["num_shards"] == 1
        and m0["report_back"]["num_shards"] == 2
        and m0["report_back"]["mode"] == "zero1",
        "A4c: back on the data mesh, one state": m0["loss_back"]
        == m1["loss_back"] and m0["state_back"][:2] == m1["state_back"][:2]
        and math.isfinite(m0["loss_back"]),
    })
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("ZeRO-1 path, leg 1: %s (losses on %s, off %s; mesh leg %s)"
             % (bad, r0["on_losses"], r0["off_losses"], {
                 k: (m0[k], m1[k]) for k in (
                     "loss", "loss_alone", "grad_rel_err", "grad_floor_max",
                     "grad_over_limit_max", "grad_rel_err_own", "launches",
                     "report")}))
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
           "mesh_leg": {k: m0[k] for k in (
               "form_s", "step_ms", "loss", "loss_alone", "grad_rel_err",
               "grad_floor_max", "grad_over_limit_max", "grad_rel_err_own",
               "bitwise_alone", "launches", "report", "back_s",
               "loss_back")},
           "mesh_leg_rank1": {k: m1[k] for k in (
               "step_ms", "grad_rel_err", "grad_over_limit_max",
               "grad_rel_err_own")},
           "checks": sorted(checks)}
    print("ZeRO-1 path, A4c mesh leg (the last world of 2 re-formed under "
          "elastic_mesh_builder(tp=2): dp=1, tp=2, both ranks on the same "
          "%d rows): re-formed in %.2f s, a step %.1f ms (rank 1 %.1f), "
          "loss %.6f against %.6f alone from the same state (gradients "
          "within %.3g of norm of the mean of the two ranks' steps alone, "
          "%.3g of its limit, the two steps alone %.3g apart; %.3g and "
          "%.3g from each rank's own; states %s), B1/B2 %s, ZeRO-1 over %d "
          "shard(s); back on the data mesh in %.2f s, %d shards, a step "
          "with one loss %.6f" % (
              COLL_BATCH, m0["form_s"], m0["step_ms"], m1["step_ms"],
              m0["loss"], m0["loss_alone"], m0["grad_rel_err"],
              max(m0["grad_over_limit_max"], m1["grad_over_limit_max"]),
              m0["grad_floor_max"], m0["grad_rel_err_own"],
              m1["grad_rel_err_own"],
              "bitwise" if m0["bitwise_alone"] else "not bitwise",
              m0["launches"], m0["report"]["num_shards"], m0["back_s"],
              m0["report_back"]["num_shards"], m0["loss_back"]))
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
# process.  Leg 3: the LoRA CLI job with a kill -9 (LORA_CLI_PARAMS).
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
    """Leg 1 of phase 20 (see CLM_BATCH); ``lm_refs``: ``multi_rank_refs``."""
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
    want = (2 * MULTI_RANK_LAYERS, MULTI_RANK_LAYERS, MULTI_RANK_LAYERS)
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
              MULTI_RANK_LAYERS, CLM_GRAD_BATCH,
              readings["f32"]["loss_ranks"],
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


# The LoRA collective CLI job with a kill -9 (phase 20, leg 3; ROADMAP
# A4c): --model_zoo lora at the flagship's widths and LORA_CLI_LAYERS
# layers (remat, rank 8, alpha 16, seeded random base), --distribution_
# strategy collective --zero1 true, two workers on the card at
# LORA_CLI_BATCH x 2048 tokens a worker; worker 0 killed -9 once both
# have stepped LORA_CLI_KILL_STEPS times in a world of 2.  Gates: the
# survivor's in-band failure, a world of 1 and its step, the relaunch, a
# world of 2 again, exit 0 with no failed task, and in each surviving
# worker B3 2 L, B4 and B5 L launches a pass (remat: the forward again in
# the backward).
LORA_CLI_LAYERS = 4
LORA_CLI_PARAMS = lm_params_at(LORA_CLI_LAYERS) + ";remat=true;rank=8;alpha=16"
LORA_CLI_BATCH = 4
LORA_CLI_KILL_STEPS = 2
# Records enough that the survivor, alone (~16 steps/s of 4 rows on an
# H100 80GB HBM3, 700 W), is still at work when its replacement joins.
LORA_CLI_RECORDS = 2048
LORA_CLI_TIMEOUT_S = 300


def lora_cli_leg(torch):
    what = "collective LM, leg 3 (LoRA CLI job, kill -9)"
    tmp = tempfile.TemporaryDirectory()
    args = ["--model_zoo", "lora", "--model_params", LORA_CLI_PARAMS,
            "--data_origin", "synthetic_lm:%d:2048:32768" % LORA_CLI_RECORDS,
            "--batch_size", str(LORA_CLI_BATCH),
            "--num_minibatches_per_task", "4", "--num_workers", "2",
            "--distribution_strategy", "collective", "--zero1", "true",
            "--log_loss_steps", "1"]
    job = _MasterProcess(args, _worker_env(), tmp.name, what=what)
    deadline = job.t0 + LORA_CLI_TIMEOUT_S
    epoch = r"rendezvous epoch (\d+): world=\[%s\]"
    step = r"\[worker-%d\] .* step \d+ loss"
    try:
        t_w2, _ = job.wait_for(epoch % r"'worker-\d', 'worker-\d'", deadline)
        for w in (0, 1):
            job.wait_for(step % w, deadline, after=t_w2,
                         count=LORA_CLI_KILL_STEPS)
        os.kill(job.worker_pid(0), signal.SIGKILL)
        t_kill = time.perf_counter()
        t_fail, _ = job.wait_for(r"\[worker-1\] .*minibatch failed "
                                 r"\(attempt 1\)", deadline, after=t_kill)
        t_w1, _ = job.wait_for(epoch % r"'worker-1'", deadline, after=t_kill)
        t_s1, _ = job.wait_for(step % 1, deadline, after=t_w1)
        t_launch, _ = job.wait_for(r"launched worker 2\b", deadline,
                                   after=t_kill)
        try:
            rc = job.proc.wait(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail("%s: the job did not finish within %d s; its tail:\n%s"
                 % (what, LORA_CLI_TIMEOUT_S, job.tail()))
        t_end = time.perf_counter()
    finally:
        job.stop()
        tmp.cleanup()
    log = "".join(line for _, line in job.lines)
    finished = re.search(r"job finished: .*'failed': \{0: 0, ", log)
    if rc != 0 or not finished:
        fail("%s: rc %s, job finished with no failed task: %s; tail:\n%s"
             % (what, rc, bool(finished), job.tail()))
    steps = {w: [t for t, line in job.lines if re.search(step % w, line)]
             for w in (0, 1, 2)}
    regrown = [t for t, line in job.lines if t >= t_launch and re.search(
        epoch % r"'worker-1', 'worker-2'", line)]
    L = LORA_CLI_LAYERS
    launches = {}
    for w in (1, 2):
        c = _logged_launches(log, w, what)
        n = c["train_passes"]
        if steps[w] and not (n >= len(steps[w]) and c["flash_fwd"] == 2 * L
                             * n and c["flash_bwd_dq"] == c["flash_bwd_dkv"]
                             == L * n):
            fail("%s: worker %d launched %s over %d logged steps, want B3 "
                 "%d, B4 and B5 %d a pass" % (what, w, c, len(steps[w]),
                                               2 * L, L))
        launches[w] = c
    placed = r"\[worker-%d\] .*zero1: optimizer state sharded 2 ways"
    if not all(any(re.search(placed % w, line) for t, line in job.lines
                   if t < t_kill) for w in (0, 1)):
        fail("%s: the workers logged no ZeRO-1 placement at a world of 2"
             % what)
    out = {"records": LORA_CLI_RECORDS, "batch": LORA_CLI_BATCH,
           "layers": L, "job_s": t_end - job.t0,
           "world2_at_s": t_w2 - job.t0, "kill_at_s": t_kill - job.t0,
           "kill_to_failure_s": t_fail - t_kill,
           "kill_to_world1_step_s": t_s1 - t_kill,
           "kill_to_relaunch_s": t_launch - t_kill,
           "kill_to_world2_epoch_s": (regrown[0] - t_kill) if regrown
           else None,
           "steps": {w: len(s) for w, s in steps.items()},
           "launches": launches, "rc": rc}
    print("%s (flagship widths at %d layers, LoRA rank 8, remat, ZeRO-1, 2 "
          "workers x %d x 2048 tokens on the card, %d records): world of 2 "
          "at %.1f s, kill -9 of worker 0 at %.1f s; the survivor's failure "
          "%.2f s after, its first step alone %.2f s after, the relaunch "
          "%.2f s after, a world of 2 again %s; steps by worker %s; "
          "launches %s; exit 0 in %.1f s, 0 failed tasks" % (
              what, L, LORA_CLI_BATCH, LORA_CLI_RECORDS, out["world2_at_s"],
              out["kill_at_s"], out["kill_to_failure_s"],
              out["kill_to_world1_step_s"], out["kill_to_relaunch_s"],
              "%.2f s after" % out["kill_to_world2_epoch_s"] if regrown
              else "never (the job ended first)", out["steps"],
              json.dumps({w: {k: c[k] for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv",
                                                "train_passes")}
                          for w, c in launches.items()}), out["job_s"]))
    return out


def collective_lm_phase(torch, lm_refs):
    return {"ranks": clm_ranks_leg(torch, lm_refs),
            "mnist_torch": mnist_torch_leg(torch),
            "lora_cli": lora_cli_leg(torch)}


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


# Phase 22: DeepFM on the parameter-server path (ROADMAP A8, A9).  Leg 1,
# in this process: the port's ParameterServerTrainer on the card against
# two PS shard processes (``python -m elasticdl_tpu_torch.ps.server``,
# the spec's Adam on the native kernels) at bench_deepfm.py's shape
# (bench_deepfm.py:46-48: batch 512, vocab 100,000, 10 fields, embedding
# dim 8, 4 dense features; DeepFM's hidden (128, 64)).  Leg 2: the master
# CLI with --distribution_strategy ps, two shards and two workers on the
# card, shard 0 killed -9 once the checkpoint holds a committed label.
PS_BATCH = 512
PS_VOCAB = 100_000
PS_FIELDS = 10
PS_DIM = 8
PS_DENSE = 4
PS_HIDDEN = (128, 64)
PS_BATCHES = 4                 # the timed steps cycle over these
PS_TIMED_STEPS = 20            # a sync mode, after one warm-up step
# Step 1 on the card against the same step on the CPU (the same pulled
# rows, float32, TF32 off): the loss within PS_LOSS_RTOL relative, each
# dense gradient and each table's row gradients within PS_GRAD_RTOL
# norm-relative.  Both sum the same float32 terms in other orders (the
# batch's 512 examples into a weight gradient, the 10 fields into a row's):
# a few float32 ulps, 1e-7 to 1e-6; 1e-5 leaves room for that and none for
# a wrong term.
PS_LOSS_RTOL = 1e-5
PS_GRAD_RTOL = 1e-5
PS_CLI_RECORDS = PS_BATCH * 192
PS_CLI_CHECKPOINT_STEPS = 16
PS_CLI_TIMEOUT_S = 100
PHASE22_BUDGET_S = 120


class _Shards:
    """``n`` PS shard processes of the port, each logging to a file."""

    def __init__(self, n, opt, use_async, env, tmp, name):
        from elasticdl_tpu_torch.utils.grpc_utils import find_free_port

        self.ports = [find_free_port() for _ in range(n)]
        self.logs = [os.path.join(tmp, "%s-%d.log" % (name, i))
                     for i in range(n)]
        self.procs = []
        for i, (port, log) in enumerate(zip(self.ports, self.logs)):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
                     "--port", str(port), "--ps_id", str(i), "--num_ps",
                     str(n), "--opt_type", opt[0], "--opt_args", opt[1],
                     "--use_async", str(use_async)],
                    env=env, stdout=subprocess.DEVNULL, stderr=f))

    @property
    def addrs(self):
        return ",".join("localhost:%d" % p for p in self.ports)

    def tail(self):
        out = []
        for log in self.logs:
            with open(log) as f:
                out.append("".join(f.readlines()[-10:]))
        return "\n".join(out)

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def _ps_batches(spec):
    from elasticdl_tpu_torch.models import deepfm

    dense, ids, labels = deepfm.synthetic_data(
        n=PS_BATCH * PS_BATCHES, num_dense=PS_DENSE, num_fields=PS_FIELDS,
        vocab_size=PS_VOCAB, seed=0)
    return [spec.feed([(dense[j], ids[j], labels[j])
                       for j in range(i, i + PS_BATCH)])
            for i in range(0, len(labels), PS_BATCH)]


def _ps_step1(torch, card, cpu, batch):
    """Step 1 of the card trainer against the CPU trainer's on the same
    prepared inputs (the rows pulled once): readings, or a failure."""
    from elasticdl_tpu_torch.worker.ps_trainer import _pad_host_batch

    (features, labels), weights = _pad_host_batch(batch, PS_BATCH)
    feats, emb, _ = card._prepare_embeddings(features)
    got = card.grad_step(feats, labels, weights, emb)
    torch.cuda.synchronize()
    ref = cpu.grad_step(feats, labels, weights, emb)
    loss_gap = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    errs = {}
    names = [name for _, name, _ in card._params] + [
        "rows:" + t for t in sorted(emb)]
    for name, g, r in zip(names, got[1] + got[2], ref[1] + ref[2]):
        if not bool(g.isfinite().all()):
            fail("PS path, leg 1: the card's step-1 gradient of %s is not "
                 "finite" % name)
        errs[name] = norm_rel(g.cpu(), r)
    bad = {n: e for n, e in errs.items() if not e <= PS_GRAD_RTOL}
    if bad or not loss_gap <= PS_LOSS_RTOL:
        fail("PS path, leg 1: step 1 on the card against the CPU: loss %r "
             "vs %r (gap %.3g, limit %g), gradients past %g norm-relative: "
             "%s" % (float(got[0]), float(ref[0]), loss_gap, PS_LOSS_RTOL,
                     PS_GRAD_RTOL, bad))
    return {"loss": float(got[0]), "loss_cpu": float(ref[0]),
            "loss_rel_gap": loss_gap, "grad_rel_err": errs,
            "grad_rel_err_max": max(errs.values())}


def _ps_timed(torch, trainer, data, what, warmup=1, steps=PS_TIMED_STEPS):
    """``warmup`` steps, then ``steps`` timed steps cycling over the
    batches (the next batch's rows prefetched, as the worker loop does):
    losses, steps/s and the trainer's per-phase ms."""
    for s in range(warmup):
        float(trainer.train_minibatch(*data[s % len(data)])[0])
    trainer.timing.reset()
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        trainer.prefetch_embeddings(data[(s + warmup + 1) % len(data)][0])
        losses.append(float(trainer.train_minibatch(
            *data[(s + warmup) % len(data)])[0]))
    trainer.drain_pushes()
    wall = time.perf_counter() - t0
    first, last = (np.mean(losses[:PS_BATCHES]),
                   np.mean(losses[-PS_BATCHES:]))
    if not all(map(math.isfinite, losses)) or not last < first:
        fail("PS path, %s: the loss did not fall over %d steps: %s"
             % (what, steps, losses))
    summary = trainer.timing.summary()
    # ms a step of each part (the embedding pull is one a table); the
    # push is its RPC when inline, its hand-off to the push thread when
    # pipelined, and the wait for it before the next dense pull is the
    # drain; the rest is host work (padding, unique ids, the batch).
    ms = {name: summary[key]["total_s"] * 1e3 / steps
          if key in summary else 0.0
          for name, key in (("dense_pull", "get_model"),
                            ("embedding_pull", "pull_embedding"),
                            ("device_step", "batch_process"),
                            ("push", "report_gradient"),
                            ("push_drain", "push_drain"))}
    step_ms = wall * 1e3 / steps
    ms["other"] = step_ms - sum(ms.values())
    return {"losses": losses, "steps_per_s": steps / wall,
            "step_ms": step_ms, "ms": ms,
            "embedding_pulls_per_step": summary.get(
                "pull_embedding", {}).get("count", 0) / steps,
            "counters": trainer.timing.counters()}


def ps_trainer_leg(torch, fa, gn, env, tmp):
    """Leg 1 of phase 22 (see PS_BATCH)."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.utils.retry import ps_rpc_policy
    from elasticdl_tpu_torch.worker.ps_client import build_ps_client
    from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer

    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    use_float32_numerics()
    spec = deepfm.model_spec(num_dense=PS_DENSE, num_fields=PS_FIELDS,
                             vocab_size=PS_VOCAB, embedding_dim=PS_DIM,
                             hidden=PS_HIDDEN)
    data = _ps_batches(spec)
    t0 = time.perf_counter()
    # A fleet a mode: atomic sync, bench_deepfm.py's settings (async
    # shards, the push serialized) and async push window 1.
    fleets = {k: _Shards(2, spec.ps_optimizer, k != "sync", env, tmp, k)
              for k in ("sync", "serial", "window")}
    try:
        clients = {k: build_ps_client(f.addrs, retry=ps_rpc_policy(),
                                      dedicated_push_channels=k == "window")
                   for k, f in fleets.items()}
        shards_s = time.perf_counter() - t0
        zero_flash_counts(fa)
        gn.LAUNCHES = gn.BWD_LAUNCHES = fa.PARTIAL_LAUNCHES = 0
        card = ParameterServerTrainer(spec, clients["sync"], PS_BATCH,
                                      atomic_sync=True, rng_seed=0,
                                      device=DEVICE)
        # The CPU trainer finds the shards initialized: it pulls the card
        # trainer's initial parameters.
        cpu = ParameterServerTrainer(
            spec, build_ps_client(fleets["sync"].addrs), PS_BATCH,
            atomic_sync=True, rng_seed=1, device="cpu")
        same = all(np.array_equal(a, b) for a, b in zip(
            card.export_parameters().values(),
            cpu.export_parameters().values()))
        if not same or card.device.type != torch.device(DEVICE).type:
            fail("PS path, leg 1: the CPU trainer's parameters are not the "
                 "card trainer's pushed ones (or the card trainer is on "
                 "%s)" % card.device)
        step1 = _ps_step1(torch, card, cpu, data[0])
        cpu.close()
        timed = {"atomic sync": _ps_timed(torch, card, data,
                                          "leg 1, atomic sync")}
        card.close()
        for key, what, push_window in (
                ("serial", "async, push serialized", 0),
                ("window", "async push window 1", 1)):
            card = ParameterServerTrainer(spec, clients[key], PS_BATCH,
                                          async_push_window=push_window,
                                          rng_seed=0, device=DEVICE)
            timed[what] = _ps_timed(torch, card, data, "leg 1, " + what)
            card.close()
        # Each kernel's launches over the phase's DeepFM steps, by the
        # name of its row in the kernels line.
        launches = {
            "group_norm_fwd": gn.LAUNCHES,
            "group_norm_bwd": gn.BWD_LAUNCHES,
            "flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_partial_fwd": fa.PARTIAL_LAUNCHES,
            "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_attention_bwd_dkv": fa.BWD_DKV_LAUNCHES}
        if any(launches.values()):
            fail("PS path, leg 1: the DeepFM steps launched kernels of "
                 "ops/: %s" % launches)
    except BaseException:
        for f in fleets.values():
            print(f.tail(), file=sys.stderr)
        raise
    finally:
        for f in fleets.values():
            f.stop()
    smi = nvidia_smi_line()
    for what, r in timed.items():
        print("PS path, leg 1 (DeepFM, batch %d, vocab %d, %d fields, dim "
              "%d, hidden %s, Adam on 2 PS shards; %s): %s: %.1f DeepFM "
              "steps/s (%.2f ms a step over %d steps); ms a step: dense "
              "pull %.3f, embedding pull %.3f (%.1f pulls), device step "
              "%.3f, push %.3f, push drain %.3f, other host work %.3f; "
              "loss %.4f -> %.4f" % (
                  PS_BATCH, PS_VOCAB, PS_FIELDS, PS_DIM, PS_HIDDEN, smi,
                  what, r["steps_per_s"], r["step_ms"], PS_TIMED_STEPS,
                  r["ms"]["dense_pull"], r["ms"]["embedding_pull"],
                  r["embedding_pulls_per_step"], r["ms"]["device_step"],
                  r["ms"]["push"], r["ms"]["push_drain"], r["ms"]["other"],
                  r["losses"][0], r["losses"][-1]))
    print("PS path, leg 1: step 1 on the card against the CPU on the same "
          "pulled rows (float32, TF32 off): loss %.7f vs %.7f (gap %.3g, "
          "limit %g), worst gradient %.3g norm-relative (limit %g); shards "
          "up in %.2f s; ops/ kernels launched: none" % (
              step1["loss"], step1["loss_cpu"], step1["loss_rel_gap"],
              PS_LOSS_RTOL, step1["grad_rel_err_max"], PS_GRAD_RTOL,
              shards_s))
    return {"step1": step1, "timed": timed, "shards_s": shards_s,
            "launches": launches, "card": smi}


def ps_cli_leg(torch, env, tmp):
    """Leg 2 of phase 22: the master CLI under --distribution_strategy
    ps, two shards and two workers on the card, shard 0 killed -9 once a
    label is committed; returns the leg's numbers."""
    from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

    ckpt = os.path.join(tmp, "ps_ckpt")
    args = ["--model_zoo", "deepfm",
            "--data_origin", "synthetic_ctr:%d" % PS_CLI_RECORDS,
            "--batch_size", str(PS_BATCH),
            "--num_minibatches_per_task", "4", "--num_workers", "2",
            "--distribution_strategy", "ps", "--num_ps", "2",
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(PS_CLI_CHECKPOINT_STEPS),
            "--log_loss_steps", "16"]
    job = _MasterProcess(args, env, tmp, what="PS path, leg 2")
    deadline = job.t0 + PS_CLI_TIMEOUT_S
    saver = CheckpointSaver(ckpt)
    try:
        launched = {w: job.wait_for(r"launched worker %d\b" % w,
                                    deadline)[0] for w in (0, 1)}
        ready = {w: job.wait_for(r"worker %d training on (\S+) against PS"
                                 % w, deadline) for w in (0, 1)}
        while not saver.latest_resumable_version(2):
            if job.proc.poll() is not None or time.perf_counter() > deadline:
                fail("PS path, leg 2: no committed checkpoint; tail:\n%s"
                     % job.tail())
            time.sleep(0.05)
        committed = saver.latest_resumable_version(2)
        # A process's threads may be listed among the children: one
        # thread group is one shard.
        pids = sorted({_tgid(pid) for pid in job.children()
                       if _is_shard(pid, 0)})
        if len(pids) != 1:
            fail("PS path, leg 2: %d children serve PS 0" % len(pids))
        os.kill(pids[0], signal.SIGKILL)
        t_kill = time.perf_counter()
        job.wait_for(r"PS 0 died \(code -9\); relaunching with restore",
                     deadline, after=t_kill)
        t_restored, m = job.wait_for(
            r"restored PS shard 0 from version (\d+)", deadline,
            after=t_kill)
        restored = int(m.group(1))
        t_rec, _ = job.wait_for(r"\[worker-\d\] .*reconciled PS restart",
                                deadline, after=t_kill)
        try:
            rc = job.proc.wait(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail("PS path, leg 2: the job did not finish within %d s; its "
                 "tail:\n%s" % (PS_CLI_TIMEOUT_S, job.tail()))
        t_end = time.perf_counter()
    finally:
        job.stop()
    log = "".join(line for _, line in job.lines)
    finished = re.search(r"job finished: .*'failed': \{0: 0, ", log)
    latest = saver.latest_resumable_version(2)
    devices = {m.group(1).split(":")[0] for _, m in ready.values()}
    if (rc != 0 or not finished or "launched worker 2" in log
            or not restored >= committed or not latest
            or not latest > restored
            or devices != {torch.device(DEVICE).type}):
        fail("PS path, leg 2: rc %s, finished with no failed task %s, a "
             "worker relaunched %s, restored version %d (committed %d), "
             "newest committed label %s, workers on %s; tail:\n%s" % (
                 rc, bool(finished), "launched worker 2" in log, restored,
                 committed, latest, devices, job.tail()))
    out = {"records": PS_CLI_RECORDS, "batch": PS_BATCH,
           "launched_s": {w: t - job.t0 for w, t in launched.items()},
           "ready_s": {w: t - job.t0 for w, (t, _) in ready.items()},
           "committed_before_kill": committed,
           "kill_after_start_s": t_kill - job.t0,
           "shard_restored_s": t_restored - t_kill,
           "recovery_s": t_rec - t_kill, "restored_version": restored,
           "final_committed_version": latest, "job_s": t_end - job.t0,
           "rc": rc}
    print("PS path, leg 2 (CLI, 2 PS shards, 2 workers on the card, "
          "DeepFM batch %d over %d records): workers launched %.1f s and "
          "%.1f s after the master started, ready at %.1f s and %.1f s; "
          "PS 0 killed -9 at %.1f s (label %d committed); the relaunched "
          "shard restored version %d %.2f s after the kill, a worker "
          "reconciled %.2f s after it (recovery); job finished exit 0 in "
          "%.1f s with no failed task and no worker relaunched, newest "
          "committed label %d" % (
              PS_BATCH, PS_CLI_RECORDS, out["launched_s"][0],
              out["launched_s"][1], out["ready_s"][0], out["ready_s"][1],
              out["kill_after_start_s"], committed, restored,
              out["shard_restored_s"], out["recovery_s"], out["job_s"],
              latest))
    return out


def _tgid(pid):
    with open("/proc/%d/status" % pid) as f:
        for line in f:
            if line.startswith("Tgid:"):
                return int(line.split()[1])
    return pid


def _is_shard(pid, ps_id):
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            argv = f.read().split(b"\0")
    except OSError:
        return False
    return (b"elasticdl_tpu_torch.ps.server" in argv and b"--ps_id" in argv
            and argv[argv.index(b"--ps_id") + 1] == str(ps_id).encode())


def ps_phase(torch, fa, gn):
    """DeepFM on the parameter-server path (module docstring, phase 22);
    fails past PHASE22_BUDGET_S."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("ELASTICDL_TORCH_DEVICE", None)     # the workers' default: cuda
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    try:
        out = {"trainer": ps_trainer_leg(torch, fa, gn, env, tmp.name)}
        out["cli"] = ps_cli_leg(torch, env, tmp.name)
    finally:
        tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > PHASE22_BUDGET_S:
        fail("PS path: the phase took %.1f s, past its budget of %d s"
             % (out["phase_s"], PHASE22_BUDGET_S))
    return out


# The serving fleet (phase 23).  Leg 1, in this process: ResNet-50 at
# 224 served by the port's batching ModelEndpoint behind build_server,
# pad buckets 1, 2, 4, 8; FLEET_CLIENTS client threads send
# FLEET_REQUESTS requests each of 1-3 images, half JSON and half binary
# frames; then the same load with batching off (one predict at a time),
# and the same requests all as frames, batched.
# Leg 2: two replica processes (``python -m
# elasticdl_tpu_torch.serving.server --fleet_managed true``, launched by
# the fleet's ProcessReplicaSpawner) behind the port's Router in this
# process; version 2 is published under a storm of keyed JSON and binary
# requests and rolled out through the prepare/commit barrier, then one
# replica is drained by SIGTERM.  Pixel values are integers 0-255 (raw
# pixels; short JSON numbers).
FLEET_IMAGE = 224
FLEET_PARAMS = "variant=resnet50;num_classes=1000;image_size=%d" % FLEET_IMAGE
FLEET_MAX_BATCH = 8
FLEET_BUCKETS = 4                  # 1, 2, 4, 8: every one warmed at load
FLEET_TIMEOUT_MS = 5.0
FLEET_CLIENTS = 16
FLEET_REQUESTS = 4
FLEET_STORM_CLIENTS = 4
FLEET_GRACE_S = 20.0               # a replica's --drain_grace_secs
FLEET_READY_S = 60.0               # a replica's start-up limit
FLEET_ROLLOUT_S = 60.0             # publish -> commit limit
PHASE23_BUDGET_S = 90
ROUTE_REPS = 7                     # executed batches per route, in turns


def _fleet_post(conn, path, blob, binary, tc):
    """POST one request on a keep-alive connection; (status, raw)."""
    conn.request("POST", path, body=blob, headers={
        "Content-Type": tc.FRAME_CONTENT_TYPE if binary
        else "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _fleet_answer(tc, status, raw, binary, what):
    """(rows, version) of a 200 answer in either wire; fails otherwise."""
    if status != 200:
        fail("%s: answered %d: %s" % (what, status, raw[:300]))
    if binary:
        frame = tc.decode_frame(raw)
        rows = tc.unflatten_tree(frame.meta["tree"], frame.tensors)
        return np.asarray(rows, np.float32), frame.model_version
    out = json.loads(raw)
    return np.asarray(out["predictions"], np.float32), out["model_version"]


def _fleet_check_rows(rows, ref, what):
    """Each row within 1e-3 * max|logit| of its plain-GN reference row
    (phase 5's tolerance); returns the worst error relative to it."""
    if rows.shape != ref.shape or not np.isfinite(rows).all():
        fail("%s: rows of shape %s (want %s), finite %s"
             % (what, rows.shape, ref.shape, np.isfinite(rows).all()))
    worst = 0.0
    for got, want in zip(rows, ref):
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > 1e-3 * scale:
            fail("%s: a row off the plain-GN module by %.3g > %.3g"
                 % (what, err, 1e-3 * scale))
        worst = max(worst, err / scale)
    return worst


def _fleet_load(tc, port, plan):
    """One thread per client of ``plan`` (per client: [(request id,
    body, binary)]), each on its own keep-alive connection, started
    together; returns ({id: (status, raw, binary)}, latencies in ms,
    wall seconds)."""
    path = "/v1/models/resnet50:predict"
    answers, latencies, errors = {}, [], []
    lock = threading.Lock()
    start = threading.Barrier(len(plan) + 1)

    def client(requests):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            start.wait()
            for rid, blob, binary in requests:
                t0 = time.perf_counter()
                status, raw = _fleet_post(conn, path, blob, binary, tc)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    answers[rid] = (status, raw, binary)
                    latencies.append(ms)
        except Exception as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(requests,),
                                daemon=True) for requests in plan]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        fail("serving fleet, leg 1: client errors %s" % errors[:3])
    return answers, latencies, wall


def _plain_refs(torch, gn, module, images):
    """The module's logits with the plain GroupNorm, in batches of the
    top bucket; fails if the kernel launched."""
    from elasticdl_tpu_torch.models import resnet

    before = gn.LAUNCHES
    with plain_group_norm(resnet, gn), torch.inference_mode():
        refs = np.concatenate([
            module(torch.from_numpy(images[i:i + FLEET_MAX_BATCH]).to(DEVICE))
            .float().cpu().numpy()
            for i in range(0, len(images), FLEET_MAX_BATCH)])
    if gn.LAUNCHES != before:
        fail("serving fleet: the plain reference launched the kernel")
    return refs


def fleet_leg1(torch, gn, tc, base, module):
    """Leg 1 of phase 23 over the export of ``module`` (version 1);
    returns the leg's numbers."""
    from elasticdl_tpu_torch.serving.batcher import BatchConfig
    from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server

    rng = np.random.RandomState(23)
    plan, frames_only, images, sizes = [], [], [], {}
    for c in range(FLEET_CLIENTS):
        requests, frames = [], []
        for j in range(FLEET_REQUESTS):
            rid = c * FLEET_REQUESTS + j
            x = rng.randint(0, 256, (1 + rid % 3, FLEET_IMAGE, FLEET_IMAGE,
                                     3)).astype(np.float32)
            frame = tc.encode_frame({"instances": x}, kind="predict")
            if (c + j) % 2:
                requests.append((rid, frame, True))
            else:
                requests.append((rid, json.dumps(
                    {"instances": x.tolist()}).encode(), False))
            frames.append((rid, frame, True))
            sizes[rid] = (sum(len(i) for i in images), len(x))
            images.append(x)
        plan.append(requests)
        frames_only.append(frames)
    images = np.concatenate(images)

    # No CUDA tensor may reach the plain GroupNorm on the served path.
    plain_on_card = [0]
    fwd_ref = gn._fwd_ref

    def counted_ref(x3, *args):
        if x3.device.type == "cuda":
            plain_on_card[0] += 1
        return fwd_ref(x3, *args)

    out = {}
    gn._fwd_ref = counted_ref
    try:
        # The mixed load batched and serialized, then the same requests
        # all as frames, batched: what JSON costs the executor.
        for mode, load in (("batched", plan), ("serialized", plan),
                           ("batched frames", frames_only)):
            gn.LAUNCHES = 0
            batching = (BatchConfig(max_batch_size=FLEET_MAX_BATCH,
                                    batch_timeout_ms=FLEET_TIMEOUT_MS,
                                    warm=True)
                        if mode != "serialized" else None)
            t0 = time.perf_counter()
            endpoint = ModelEndpoint(base, device=DEVICE, batching=batching)
            load_s = time.perf_counter() - t0
            warm_launches = gn.LAUNCHES
            server = build_server(endpoint, port=0)
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                answers, latencies, wall = _fleet_load(tc, port, load)
                launches = gn.LAUNCHES
                statz = json.loads(http_get(port, "/statz"))
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
                endpoint.close()
            row = {"images_per_s": len(images) / wall, "wall_s": wall,
                   "p50_ms": float(np.percentile(latencies, 50)),
                   "p99_ms": float(np.percentile(latencies, 99)),
                   "load_s": load_s, "launches": launches,
                   "warm_launches": warm_launches}
            got = {}
            for rid, (status, raw, binary) in answers.items():
                rows, version = _fleet_answer(
                    tc, status, raw, binary,
                    "serving fleet, leg 1, %s, request %d" % (mode, rid))
                if version != 1:
                    fail("serving fleet, leg 1: version %s, want 1"
                         % version)
                got[rid] = rows
            if len(got) != FLEET_CLIENTS * FLEET_REQUESTS:
                fail("serving fleet, leg 1: %d answers of %d" % (
                    len(got), FLEET_CLIENTS * FLEET_REQUESTS))
            row["answers"] = got
            stats = statz["models"]["resnet50"]
            counters = stats["counters"]
            if batching is not None:
                batches = counters.get("batcher.batches", 0)
                if counters.get("batcher.warmed_models") != 1:
                    fail("serving fleet, leg 1: /statz warmed_models %s, "
                         "want 1" % counters.get("batcher.warmed_models"))
                if counters.get("batcher.raw_requests"):
                    fail("serving fleet, leg 1: %d requests took the raw "
                         "path" % counters["batcher.raw_requests"])
                if not batches < counters.get("batcher.requests", 0):
                    fail("serving fleet, leg 1: %d batches for %d requests:"
                         " nothing coalesced" % (
                             batches, counters.get("batcher.requests", 0)))
                want = GN_PER_FORWARD * (batches + FLEET_BUCKETS)
                if launches != want or warm_launches != (
                        GN_PER_FORWARD * FLEET_BUCKETS):
                    fail("serving fleet, leg 1: B1 launched %d times (%d at "
                         "warm-up) over %d batches and %d warmed buckets, "
                         "want %d" % (launches, warm_launches, batches,
                                      FLEET_BUCKETS, want))
                wait_p99 = endpoint.timing.percentile("batcher.queue_wait",
                                                      0.99)
                row.update(
                    batches=batches,
                    requests=counters["batcher.requests"],
                    padded_rows=counters.get("batcher.padded_rows", 0),
                    mean_occupancy=stats["mean_batch_occupancy"],
                    queue_wait_p99_ms=1e3 * wait_p99,
                    queue_wait_mean_ms=1e3 * stats["timing"][
                        "batcher.queue_wait"]["mean_s"],
                    execute_mean_ms=1e3 * stats["timing"][
                        "batcher.execute"]["mean_s"],
                    warmup_s=stats["timing"]["batcher.warmup"]["total_s"])
                if endpoint.model.program is None:
                    fail("serving fleet, leg 1: the export loaded without "
                         "its program")
            elif launches != GN_PER_FORWARD * len(answers):
                fail("serving fleet, leg 1: B1 launched %d times over %d "
                     "serialized requests, want %d each" % (
                         launches, len(answers), GN_PER_FORWARD))
            out[mode] = row
            del endpoint
    finally:
        gn._fwd_ref = fwd_ref
    if plain_on_card[0]:
        fail("serving fleet, leg 1: %d CUDA tensors reached the plain "
             "GroupNorm" % plain_on_card[0])
    refs = _plain_refs(torch, gn, module, images)
    for mode in out:
        worst = 0.0
        for rid, rows in out[mode].pop("answers").items():
            start, n = sizes[rid]
            worst = max(worst, _fleet_check_rows(
                rows, refs[start:start + n],
                "serving fleet, leg 1, %s, request %d" % (mode, rid)))
        out[mode]["max_rel_err"] = worst
    out["images"] = len(images)
    out["requests"] = FLEET_CLIENTS * FLEET_REQUESTS
    b, s, f = out["batched"], out["serialized"], out["batched frames"]
    print("fleet leg 1: %d requests, %d images, half JSON half binary, "
          "%d clients; batched: %.1f images/s, p50 %.1f ms, p99 %.1f ms, "
          "%d batches (mean occupancy %.2f, %d padded rows), queue wait "
          "p99 %.2f ms, mean %.2f ms, execute mean %.2f ms, load %.1f s "
          "(warm-up %.2f s), B1 %d = %d x (%d + %d); serialized: %.1f "
          "images/s, p50 %.1f ms, p99 %.1f ms; frames only, batched: %.1f "
          "images/s, p50 %.1f ms, p99 %.1f ms, %d batches, execute mean "
          "%.2f ms; max err / max|logit| %.3g / %.3g / %.3g" % (
              out["requests"], out["images"], FLEET_CLIENTS,
              b["images_per_s"], b["p50_ms"], b["p99_ms"], b["batches"],
              b["mean_occupancy"], b["padded_rows"], b["queue_wait_p99_ms"],
              b["queue_wait_mean_ms"], b["execute_mean_ms"], b["load_s"],
              b["warmup_s"], b["launches"], GN_PER_FORWARD, b["batches"],
              FLEET_BUCKETS,
              s["images_per_s"], s["p50_ms"], s["p99_ms"], f["images_per_s"],
              f["p50_ms"], f["p99_ms"], f["batches"], f["execute_mean_ms"],
              b["max_rel_err"], s["max_rel_err"], f["max_rel_err"]),
          flush=True)
    return out


def _fleet_ready(port, proc_poll, deadline, what):
    """Wait until a replica's /statz shows its model warmed; fails if
    the process exits or the deadline passes."""
    while True:
        if proc_poll() is not None:
            fail("%s exited with %s before it served" % (what, proc_poll()))
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            try:
                conn.request("GET", "/statz")
                resp = conn.getresponse()
                body = resp.read()
            finally:
                conn.close()
            if resp.status == 200:
                models = json.loads(body)["models"]
                if all(m["counters"].get("batcher.warmed_models") == 1
                       for m in models.values()):
                    return models
        except OSError:
            pass
        if time.perf_counter() > deadline:
            fail("%s not ready (warmed) within %.0f s" % (what,
                                                          FLEET_READY_S))
        time.sleep(0.2)


def fleet_leg2(torch, gn, tc, base, module_v1, exporter, spawner, addrs,
               t0):
    """Leg 2 of phase 23 over the replicas ``spawner`` launched at ``t0``
    (``addrs``); version 2 is published through ``exporter``, the
    ContinuousExporter that wrote version 1.  Returns the leg's
    numbers."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.serving.export import ServingFunction
    from elasticdl_tpu_torch.serving.router import Router, build_router_server

    spec = load_model_spec("resnet", FLEET_PARAMS)
    module_v2 = spec.init_fn(DEVICE)
    module_v2.load_state_dict(spec.params_from_jax(
        seeded_params(spec, module_v2, seed=2)))
    rng = np.random.RandomState(24)
    storm = rng.randint(0, 256, (FLEET_STORM_CLIENTS, 1, FLEET_IMAGE, FLEET_IMAGE, 3)
                        ).astype(np.float32)
    flat = storm.reshape(-1, FLEET_IMAGE, FLEET_IMAGE, 3)
    refs = {1: _plain_refs(torch, gn, module_v1, flat),
            2: _plain_refs(torch, gn, module_v2, flat)}
    out = {}
    router = front = None
    try:
        for addr in addrs:
            _fleet_ready(int(addr.rsplit(":", 1)[1]),
                         lambda a=addr: spawner.poll(a),
                         t0 + FLEET_READY_S, "replica %s" % addr)
        out["replicas_ready_s"] = time.perf_counter() - t0
        router = Router(addrs, export_dir=base, probe_interval=0.2,
                        poll_interval=0.25, barrier_timeout=FLEET_ROLLOUT_S)
        front = build_router_server(router, port=0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        router.start()
        deadline = time.perf_counter() + 10
        while (router.coordinator.committed_version != 1
               or len(router.state.routable(1)) != 2):
            if time.perf_counter() > deadline:
                fail("serving fleet, leg 2: the router did not seed "
                     "version 1 over both replicas: %s"
                     % (router.fleet_status(),))
            time.sleep(0.05)

        port = front.server_address[1]
        log, errors = [], []
        lock = threading.Lock()
        stop = threading.Event()

        def client(c):
            x = storm[c]
            blobs = (json.dumps({"instances": x.tolist(),
                                 "routing_key": "storm-%d" % c}).encode(),
                     tc.encode_frame({"instances": x}, kind="predict",
                                     routing_key="storm-%d" % c))
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            k = 0
            try:
                while not stop.is_set():
                    binary = (c + k) % 2 == 1
                    t_send = time.perf_counter()
                    status, raw = _fleet_post(
                        conn, "/v1/models/resnet50:predict",
                        blobs[binary], binary, tc)
                    with lock:
                        log.append((c, t_send, time.perf_counter(),
                                    status, raw, binary))
                    if status != 200:
                        # The connection may be closed after an error.
                        conn.close()
                    k += 1
            except Exception as e:  # noqa: BLE001 - surfaced below
                with lock:
                    errors.append(repr(e))
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(FLEET_STORM_CLIENTS)]
        for t in threads:
            t.start()
        try:
            time.sleep(1.0)
            exporter.export(2, ServingFunction(spec, module_v2),
                            spec.params_to_jax(module_v2), storm[0])
            t_publish = time.perf_counter()
            while router.coordinator.committed_version != 2:
                if time.perf_counter() > t_publish + FLEET_ROLLOUT_S:
                    fail("serving fleet, leg 2: version 2 not committed "
                         "within %.0f s: %s" % (FLEET_ROLLOUT_S,
                                                router.fleet_status()))
                time.sleep(0.01)
            t_commit = time.perf_counter()
            out["publish_to_commit_s"] = t_commit - t_publish
            time.sleep(1.0)
            victim = addrs[1]
            t_term = time.perf_counter()
            spawner.drain(victim)
            while spawner.poll(victim) is None:
                if time.perf_counter() > t_term + FLEET_GRACE_S + 10:
                    fail("serving fleet, leg 2: the drained replica did "
                         "not exit within its grace (%.0f s)"
                         % FLEET_GRACE_S)
                time.sleep(0.01)
            t_exit = time.perf_counter()
            out["drain_s"] = t_exit - t_term
            code = spawner.poll(victim)
            if code != 0 or out["drain_s"] > FLEET_GRACE_S:
                fail("serving fleet, leg 2: the drained replica exited "
                     "%s after %.1f s (want 0 within %.0f s)"
                     % (code, out["drain_s"], FLEET_GRACE_S))
            while router.state.snapshot()[0][victim]["healthy"]:
                if time.perf_counter() > t_exit + 10:
                    fail("serving fleet, leg 2: the router did not eject "
                         "the drained replica")
                time.sleep(0.01)
            out["eject_after_exit_s"] = time.perf_counter() - t_exit
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        if errors:
            fail("serving fleet, leg 2: client errors %s" % errors[:3])
        _, counters = router.state.snapshot()
        out["router_counters"] = counters
    finally:
        if router is not None:
            router.stop()
        if front is not None:
            front.shutdown()
            front.server_close()
        spawner.close()
    versions, worst = {1: 0, 2: 0}, 0.0
    after_commit = after_term = 0
    for c, t_send, t_recv, status, raw, binary in log:
        rows, version = _fleet_answer(tc, status, raw, binary,
                                      "serving fleet, leg 2, client %d" % c)
        if version not in refs:
            fail("serving fleet, leg 2: an answer stamped version %s"
                 % version)
        if version == 1 and t_send > t_commit:
            fail("serving fleet, leg 2: a request sent %.3f s after the "
                 "commit barrier answered version 1" % (t_send - t_commit))
        versions[version] += 1
        after_commit += t_send > t_commit
        after_term += t_send > t_term
        worst = max(worst, _fleet_check_rows(
            rows, refs[version][c:c + 1],
            "serving fleet, leg 2, version %d, client %d" % (version, c)))
    if not (versions[1] and versions[2] and after_term):
        fail("serving fleet, leg 2: answers by version %s, %d sent after "
             "the SIGTERM" % (versions, after_term))
    out.update(answers=len(log), by_version=versions,
               sent_after_commit=after_commit, sent_after_sigterm=after_term,
               max_rel_err=worst)
    print("fleet leg 2: 2 replicas ready (warmed) %.1f s after launch; %d "
          "storm answers, all 200 (version 1: %d, version 2: %d; %d sent "
          "after the commit, %d after the SIGTERM), max err / max|logit| "
          "%.3g; publish -> commit %.2f s; SIGTERM -> exit 0 %.2f s, "
          "ejected %.2f s later; router %s" % (
              out["replicas_ready_s"], len(log), versions[1], versions[2],
              after_commit, after_term, worst, out["publish_to_commit_s"],
              out["drain_s"], out["eject_after_exit_s"],
              json.dumps(out["router_counters"], sort_keys=True)),
          flush=True)
    return out


def _device_ms(torch, prof):
    """(kernel device ms, kernel launches) of a ``torch.profiler`` run."""
    total, launches = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            total += us
            launches += e.count
    return total / 1e3, launches


def route_compare(torch, base):
    """One batch of FLEET_MAX_BATCH images executed by the program route
    and by the zoo route of version 1 under ``base``, in turns: the
    median host ms of ROUTE_REPS predicts each (to-device copy, forward,
    logits back), then each route's kernels' device ms and launches from
    one predict under ``torch.profiler``."""
    from elasticdl_tpu_torch.serving.loader import load_servable

    x = np.random.RandomState(27).randint(0, 256, (
        FLEET_MAX_BATCH, FLEET_IMAGE, FLEET_IMAGE, 3)).astype(np.float32)
    routes = {"program": load_servable(base, device=DEVICE),
              "zoo": load_servable(base, device=DEVICE,
                                   zoo=("resnet", FLEET_PARAMS))}
    if routes["program"].program is None or routes["zoo"].module is None:
        fail("serving fleet: the two routes did not load as asked")
    rows = {key: m.predict(x) for key, m in routes.items()}
    err = float(np.abs(rows["program"] - rows["zoo"]).max()
                / (np.abs(rows["zoo"]).max() or 1.0))
    if not err < 1e-3:
        fail("serving fleet: the program and zoo routes differ by %g x "
             "max|logit|" % err)
    times = {key: [] for key in routes}
    for _ in range(ROUTE_REPS):
        for key, m in routes.items():
            t0 = time.perf_counter()
            m.predict(x)
            times[key].append(1e3 * (time.perf_counter() - t0))
    out = {"max_rel_err": err}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for key, m in routes.items():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            m.predict(x)
            host_ms = 1e3 * (time.perf_counter() - t0)
        device_ms, launches = _device_ms(torch, prof)
        out[key] = {"median_ms": float(np.median(times[key])),
                    "ms": times[key], "traced_host_ms": host_ms,
                    "traced_device_ms": device_ms,
                    "traced_kernels": launches}
    p, z = out["program"], out["zoo"]
    print("fleet routes, one batch of %d at %d: program route %.2f ms, zoo "
          "route %.2f ms (medians of %d, in turns); traced: program %.2f ms "
          "host, %.2f ms of %d kernels on the card; zoo %.2f ms host, %.2f "
          "ms of %d kernels; rows within %.3g x max|logit|" % (
              FLEET_MAX_BATCH, FLEET_IMAGE, p["median_ms"], z["median_ms"],
              ROUTE_REPS, p["traced_host_ms"], p["traced_device_ms"],
              p["traced_kernels"], z["traced_host_ms"],
              z["traced_device_ms"], z["traced_kernels"], err), flush=True)
    return out


def fleet_phase(torch, gn):
    """The serving fleet (module docstring, phase 23); fails past
    PHASE23_BUDGET_S."""
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.ops import build
    from elasticdl_tpu_torch.serving.export import (
        ContinuousExporter,
        ServingFunction,
    )
    from elasticdl_tpu_torch.serving.fleet import ProcessReplicaSpawner
    from elasticdl_tpu_torch.utils import tensor_codec as tc
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    t0 = time.perf_counter()
    use_float32_numerics()   # as the serving entry point: TF32 off
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["ELASTICDL_TORCH_DEVICE"] = DEVICE
    env["ELASTICDL_TORCH_BUILD_DIR"] = build.BUILD_DIR
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    spec = load_model_spec("resnet", FLEET_PARAMS)
    module = spec.init_fn(DEVICE)
    module.load_state_dict(spec.params_from_jax(
        seeded_params(spec, module, seed=0)))
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "resnet50")
        # One trace serves both versions (the program holds no weights).
        exporter = ContinuousExporter(base, model_name="resnet50", keep=0)
        exporter.export(1, ServingFunction(spec, module),
                        spec.params_to_jax(module),
                        np.zeros((1, FLEET_IMAGE, FLEET_IMAGE, 3), np.float32))
        # Leg 2's replica processes start now and load version 1 while
        # leg 1 runs: a fresh process spends ~15 s importing and reading
        # the program (PERF.md §5; NVIDIA H100 80GB HBM3, 700 W).
        spawner = ProcessReplicaSpawner(base, env=env, extra_args=[
            "--max_batch_size", str(FLEET_MAX_BATCH),
            "--batch_timeout_ms", str(FLEET_TIMEOUT_MS),
            "--drain_grace_secs", str(FLEET_GRACE_S)])
        t_spawn = time.perf_counter()
        addrs = [spawner.spawn() for _ in range(2)]
        try:
            out = {"leg1": fleet_leg1(torch, gn, tc, base, module)}
            out["routes"] = route_compare(torch, base)
            out["leg2"] = fleet_leg2(torch, gn, tc, base, module, exporter,
                                     spawner, addrs, t_spawn)
        finally:
            spawner.close()
        if exporter.traces != 1:
            fail("serving fleet: %d traces for two versions of one model"
                 % exporter.traces)
        del module
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > PHASE23_BUDGET_S:
        fail("serving fleet: the phase took %.1f s, past its budget of %d s"
             % (out["phase_s"], PHASE23_BUDGET_S))
    return out


# The online-learning loop (phase 24).  ResNet-50 at full width (224x224x3,
# 1000 classes, float32, TF32 off), seeded weights, SGD momentum at
# TRAIN_LR.  Leg 1, all on the card in this process: the port's
# CollectiveTrainer takes ONLINE_STEPS steps at ONLINE_BATCH on one batch
# with a ContinuousExporter (wire format "frame") every
# ONLINE_EXPORT_STEPS steps, each version streamed by ``stream_to`` through
# a FrameClient to an aggregator process (``python -m
# elasticdl_tpu_torch.aggregation.main``, mean over a window of 2) that
# publishes into the versioned base a ModelEndpoint serves (pad buckets 1,
# 2, 4, 8, each warmed at load and at each hot swap).  Leg 2: the
# train-end exporter (``models/callbacks.ModelExporter``), float32 and
# int8, each export served on the card through its program.
ONLINE_PARAMS = FLEET_PARAMS + ";learning_rate=%g" % TRAIN_LR
ONLINE_CLASSES = 1000
ONLINE_BATCH = 8
ONLINE_STEPS = 4
ONLINE_EXPORT_STEPS = 2
ONLINE_CLIENTS = 4
ONLINE_REQUESTS = 3
ONLINE_WAIT_S = 60.0               # a publish or a hot swap
# int8 rows against float32 rows, as a share of max|logit| (the bound
# tests/test_torch_export_int8.py measures and states).
INT8_REL_TOL = 0.1
PHASE24_BUDGET_S = 90


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get_json(port, path):
    """(status, JSON body) of a GET, or (None, None) while nothing
    listens."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    except OSError:
        return None, None
    finally:
        conn.close()


def _wait_until(predicate, deadline, what):
    while not predicate():
        if time.perf_counter() > deadline:
            fail("online loop: %s" % what)
        time.sleep(0.02)


def _streaming_exporter(tc, client, ready):
    """A ContinuousExporter whose ``export`` (the trainer's cadence hook)
    streams the version to the aggregator with ``stream_to``: trainer and
    aggregator share no filesystem.  It waits for ``ready`` (the
    aggregator process starting beside the first steps) before its first
    push, and keeps each version's parameters and each frame's size and
    whether the program rode in it."""
    from elasticdl_tpu_torch.serving.export import ContinuousExporter

    class StreamingExporter(ContinuousExporter):
        def __init__(self):
            super().__init__("", model_name="resnet50", wire_format="frame")
            self.snapshots, self.frames, self.export_s = {}, [], []

        def frame_bytes(self, version, *args, **kwargs):
            blob = super().frame_bytes(version, *args, **kwargs)
            names = list(dict(tc.decode_frame(blob).tensors))
            self.frames.append((version, len(blob), "__program__" in names))
            return blob

        def export(self, version, serve, params, example_input,
                   embeddings=None):
            ready()
            t0 = time.perf_counter()
            self.snapshots[version] = params
            got = self.stream_to(client, version, serve, params,
                                 example_input, embeddings=embeddings)
            self.export_s.append(time.perf_counter() - t0)
            return got

    return StreamingExporter()


def _window_mean(snapshots):
    """The aggregator's mean (``aggregated_dense``, mode "mean"): float64
    sums of equal weights, cast back."""
    versions = sorted(snapshots)
    w = 1.0 / len(versions)
    out = {}
    for name, leaf in snapshots[versions[-1]].items():
        acc = np.zeros_like(leaf, dtype=np.float64)
        for v in versions:
            acc += w * np.asarray(snapshots[v][name], np.float64)
        out[name] = acc.astype(leaf.dtype)
    return out


def _counted_plain_gn(gn):
    """Counts CUDA tensors handed to the plain GroupNorm while it is on."""
    fwd_ref = gn._fwd_ref
    seen = [0]

    def counted(x3, *args):
        if x3.device.type == "cuda":
            seen[0] += 1
        return fwd_ref(x3, *args)

    @contextlib.contextmanager
    def on():
        gn._fwd_ref = counted
        try:
            yield
        finally:
            gn._fwd_ref = fwd_ref

    return seen, on


def online_leg1(torch, gn, tc, tmp, env, timed_traces):
    from elasticdl_tpu_torch.client.frame_client import FrameClient
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.serving.batcher import BatchConfig
    from elasticdl_tpu_torch.serving.export import load_payload
    from elasticdl_tpu_torch.serving.loader import load_servable
    from elasticdl_tpu_torch.serving.server import ModelEndpoint, build_server
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    pub = os.path.join(tmp, "resnet50")
    port = _free_port()
    t_launch = time.perf_counter()
    agg_log = open(os.path.join(tmp, "aggregator.log"), "w+")
    agg = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.aggregation.main",
         "--source_dir", os.path.join(tmp, "source"), "--publish_dir", pub,
         "--window", "2", "--agg_mode", "mean", "--ingest_port", str(port),
         "--poll_interval", "0.05", "--freshness_slo_secs", "60",
         "--export_keep", "0", "--model_name", "resnet50"],
        env=env, stdout=subprocess.DEVNULL, stderr=agg_log)
    client = FrameClient("127.0.0.1:%d" % port, timeout=300)
    endpoint = server = None
    out = {}
    seen, plain_on = _counted_plain_gn(gn)
    try:
        def ready():
            if out.get("aggregator_ready_s") is not None:
                return

            def answers():
                if agg.poll() is not None:
                    agg_log.seek(0)
                    fail("online loop: the aggregator exited %s:\n%s"
                         % (agg.returncode, agg_log.read()[-2000:]))
                return _get_json(port, "/healthz")[0] == 200

            _wait_until(answers, t_launch + ONLINE_WAIT_S, "the "
                        "aggregator never answered /healthz")
            out["aggregator_ready_s"] = time.perf_counter() - t_launch

        spec = load_model_spec("resnet", ONLINE_PARAMS)
        exporter = _streaming_exporter(tc, client, ready)
        trainer = CollectiveTrainer(spec, batch_size=ONLINE_BATCH,
                                    device=DEVICE, exporter=exporter,
                                    export_steps=ONLINE_EXPORT_STEPS)
        trainer.set_params(spec.params_from_jax(
            seeded_params(spec, trainer.module, seed=24)))
        rng = np.random.RandomState(24)
        x = rng.rand(ONLINE_BATCH, FLEET_IMAGE, FLEET_IMAGE, 3).astype(
            np.float32)
        y = rng.randint(0, ONLINE_CLASSES, ONLINE_BATCH).astype(np.int32)

        losses = []

        def steps(n):
            for _ in range(n):
                losses.append(float(trainer.train_minibatch(x, y)[0]))
            trainer.flush_checkpoints()   # joins the streamed export

        def published(version):
            path = os.path.join(pub, str(version), "manifest.json")
            _wait_until(lambda: os.path.isfile(path),
                        time.perf_counter() + ONLINE_WAIT_S,
                        "version %d was never published" % version)
            return os.path.getmtime(path)

        steps(ONLINE_EXPORT_STEPS)
        published(ONLINE_EXPORT_STEPS)
        batching = BatchConfig(max_batch_size=FLEET_MAX_BATCH,
                               batch_timeout_ms=FLEET_TIMEOUT_MS, warm=True)
        endpoint = ModelEndpoint(pub, device=DEVICE, poll_interval=0.05,
                                 batching=batching)
        if (endpoint.model.program is None
                or endpoint.serving_version() != ONLINE_EXPORT_STEPS):
            fail("online loop: the endpoint serves version %s, program %s"
                 % (endpoint.serving_version(), endpoint.model.program))
        server = build_server(endpoint, port=0)
        http_port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        launches0 = gn.LAUNCHES
        steps(ONLINE_STEPS - ONLINE_EXPORT_STEPS)
        train_launches = gn.LAUNCHES - launches0
        if train_launches != GN_PER_FORWARD * (ONLINE_STEPS
                                               - ONLINE_EXPORT_STEPS):
            fail("online loop: %d B1 launches in %d training steps"
                 % (train_launches, ONLINE_STEPS - ONLINE_EXPORT_STEPS))
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail("online loop: the loss did not fall: %s" % losses)
        launches1 = gn.LAUNCHES
        t_pub = published(ONLINE_STEPS)
        # Each metadata request lets the endpoint scan for a new version.
        with plain_on():
            _wait_until(lambda: http_json(http_port, "GET",
                                          "/v1/models/resnet50")[1]
                        ["metadata"]["version"] == ONLINE_STEPS,
                        time.perf_counter() + ONLINE_WAIT_S,
                        "the endpoint never committed version %d"
                        % ONLINE_STEPS)
            t_commit = time.time()
            images, plan, sizes = [], [], {}
            for c in range(ONLINE_CLIENTS):
                requests = []
                for j in range(ONLINE_REQUESTS):
                    rid = c * ONLINE_REQUESTS + j
                    xr = rng.rand(1 + rid % 3, FLEET_IMAGE, FLEET_IMAGE,
                                  3).astype(np.float32)
                    sizes[rid] = (sum(len(i) for i in images), len(xr))
                    images.append(xr)
                    if j == 0:   # one JSON request a client
                        requests.append((rid, json.dumps(
                            {"instances": xr.tolist()}).encode(), False))
                    else:
                        requests.append((rid, tc.encode_frame(
                            {"instances": xr}, kind="predict"), True))
                plan.append(requests)
            answers, latencies, wall = _fleet_load(tc, http_port, plan)
            program_launches = gn.LAUNCHES - launches1
            statz = json.loads(http_get(http_port, "/statz"))
        counters = statz["models"]["resnet50"]["counters"]
        batches = counters.get("batcher.batches", 0)
        if counters.get("batcher.warmed_models") != 2:
            fail("online loop: warmed models %s, want 2 (versions %d, %d)"
                 % (counters.get("batcher.warmed_models"),
                    ONLINE_EXPORT_STEPS, ONLINE_STEPS))
        if program_launches != GN_PER_FORWARD * (batches + FLEET_BUCKETS):
            fail("online loop: the program launched B1 %d times over %d "
                 "batches and %d warmed buckets" % (
                     program_launches, batches, FLEET_BUCKETS))
        images = np.concatenate(images)
        got = {}
        for rid, (status, raw, binary) in answers.items():
            rows, version = _fleet_answer(tc, status, raw, binary,
                                          "online loop, request %d" % rid)
            if version != ONLINE_STEPS:
                fail("online loop: request %d stamped version %s"
                     % (rid, version))
            got[rid] = rows
        if len(got) != ONLINE_CLIENTS * ONLINE_REQUESTS:
            fail("online loop: %d answers" % len(got))
        # The published weights are the host mean of the two snapshots,
        # bit for bit; the reference is the module holding them.
        dense, _ = load_payload(os.path.join(pub, str(ONLINE_STEPS)))
        mean = _window_mean(exporter.snapshots)
        if sorted(dense) != sorted(mean) or not all(
                np.array_equal(dense[k], mean[k]) for k in mean):
            fail("online loop: the published weights are not the window "
                 "mean of the exported versions")
        ref_module = spec.init_fn(DEVICE)
        ref_module.load_state_dict(spec.params_from_jax(mean))
        refs = _plain_refs(torch, gn, ref_module, images)
        worst = 0.0
        for rid, rows in got.items():
            start, n = sizes[rid]
            worst = max(worst, _fleet_check_rows(
                rows, refs[start:start + n], "online loop, request %d"
                % rid))
        # The same published program on the CPU, in this process.
        t0 = time.perf_counter()
        on_cpu = load_servable(pub, device="cpu")
        cpu_load_s = time.perf_counter() - t0
        cpu_worst = _fleet_check_rows(on_cpu.predict(images[:2]), refs[:2],
                                      "online loop, the program on the CPU")
        stats = _get_json(port, "/status")[1]
        frames = exporter.frames
        if (exporter.traces != 1 or exporter.exports != 2
                or [p for _, _, p in frames] != [True, False]
                or exporter.stream_stats != {"pushed": 2, "stale": 0,
                                             "reprimed": 0}):
            fail("online loop: traces %d, exports %d, frames %s, stream %s"
                 % (exporter.traces, exporter.exports, frames,
                    exporter.stream_stats))
        if seen[0]:
            fail("online loop: %d CUDA tensors reached the plain GroupNorm"
                 % seen[0])
        out.update({
            "losses": losses, "trace_s": timed_traces[0],
            "first_export_s": exporter.export_s[0],
            "steady_export_s": exporter.export_s[1],
            "frame_bytes": [n for _, n, _ in frames],
            "ingest_to_publish_s": stats["freshness_seconds"],
            "publish_to_commit_s": t_commit - t_pub,
            "aggregator": stats["counters"],
            "batches": batches, "requests": len(got),
            "images": len(images), "program_launches": program_launches,
            "images_per_s": len(images) / wall,
            "p50_ms": float(np.percentile(latencies, 50)),
            "p99_ms": float(np.percentile(latencies, 99)),
            "max_rel_err": worst, "cpu_load_s": cpu_load_s,
            "cpu_max_rel_err": cpu_worst})
        print("online loop, leg 1: ResNet-50 224 f32 at batch %d, %d steps, "
              "loss %s; program traced once in %.2f s (the first export, "
              "on the training thread), versions streamed in %.2f s with "
              "the program and %.2f s without (frames of %s bytes); "
              "ingest -> publish %.3f s (the aggregator's freshness), "
              "publish -> commit %.3f s; %d requests (%d images, 1 in 3 "
              "JSON) at version %d: %.1f images/s, p50 %.1f ms, p99 %.1f "
              "ms, %d batches, B1 %d = 53 x (%d + %d) by the program; rows "
              "within %.3g x max|logit| of the plain-GN module on the "
              "window mean; the same program on the CPU loads in %.2f s and "
              "answers within %.3g" % (
                  ONLINE_BATCH, ONLINE_STEPS,
                  ["%.4f" % v for v in losses], out["trace_s"],
                  out["first_export_s"], out["steady_export_s"],
                  out["frame_bytes"], out["ingest_to_publish_s"],
                  out["publish_to_commit_s"], len(got), len(images),
                  ONLINE_STEPS, out["images_per_s"], out["p50_ms"],
                  out["p99_ms"], batches, program_launches, batches,
                  FLEET_BUCKETS, worst, cpu_load_s, cpu_worst), flush=True)
        return out, trainer
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if endpoint is not None:
            endpoint.close()
        client.close()
        agg.terminate()
        try:
            agg.wait(timeout=30)
        except subprocess.TimeoutExpired:
            agg.kill()
            agg.wait(timeout=30)
        agg_log.close()


_VIEWS = ("aten.permute.", "aten.view.", "aten.reshape.",
          "aten._unsafe_view.", "aten.transpose.", "aten.expand.",
          "aten.alias.", "aten.squeeze.", "aten.unsqueeze.", "aten.t.")
_COPIES = ("aten.clone.", "aten._to_copy.", "aten.contiguous.",
           "aten.copy.", "aten.copy_.")
_WEIGHT_USERS = ("aten.conv2d.", "aten.convolution.", "aten.linear.",
                 "elasticdl_tpu_torch.group_norm_fwd.")


def program_census(torch, vdir):
    """The forward program of the export at ``vdir``: its GroupNorm op
    nodes, the copies (through views) feeding their x, and the ops on a
    weight other than the conv, dense and GroupNorm that take it (a
    layout map run on every request)."""
    import io

    from elasticdl_tpu_torch.serving.export import (
        FORWARD_PROGRAM,
        PROGRAM_FILE,
        program_archives,
    )

    with open(os.path.join(vdir, PROGRAM_FILE), "rb") as f:
        ep = torch.export.load(io.BytesIO(
            program_archives(f.read())[FORWARD_PROGRAM]))
    out = {"group_norm_ops": 0, "copies_into_group_norm": 0,
           "layout_ops_on_weights": 0}
    for node in ep.graph.nodes:
        target = str(node.target) + "."
        if node.op == "placeholder" and node.name.startswith("state_"):
            out["layout_ops_on_weights"] += sum(
                1 for user in node.users
                if not str(user.target).startswith(_WEIGHT_USERS))
        if not target.startswith("elasticdl_tpu_torch.group_norm_fwd."):
            continue
        out["group_norm_ops"] += 1
        src = node.args[0]
        while hasattr(src, "target"):
            name = str(src.target) + "."
            if name.startswith(_COPIES):
                out["copies_into_group_norm"] += 1
                break
            if not name.startswith(_VIEWS):
                break
            src = src.args[0]
    return out


def online_leg2(torch, gn, trainer, tmp, timed_traces):
    """Leg 2: ModelExporter at train end, float32 and int8, each served on
    the card through its program; then a program written on the CPU,
    served on the card."""
    from elasticdl_tpu_torch.models.callbacks import ModelExporter
    from elasticdl_tpu_torch.models.spec import load_model_spec
    from elasticdl_tpu_torch.serving.export import export_servable
    from elasticdl_tpu_torch.serving.loader import load_servable

    out = {}
    images = np.random.RandomState(25).rand(
        FLEET_MAX_BATCH, FLEET_IMAGE, FLEET_IMAGE, 3).astype(np.float32)
    refs = _plain_refs(torch, gn, trainer.module, images)
    rows, seen, plain_on = {}, *_counted_plain_gn(gn)
    for quantize in (None, "int8"):
        key = quantize or "float32"
        base = os.path.join(tmp, "train_end_" + key)
        t0 = time.perf_counter()
        ModelExporter(base, model_name="resnet50", versioned=True,
                      quantize=quantize).on_train_end(trainer)
        export_s = time.perf_counter() - t0
        vdir = os.path.join(base, str(trainer.version))
        with open(os.path.join(vdir, "manifest.json")) as f:
            fmt = json.load(f)["format"]
        if (quantize is not None) != fmt.startswith("int8-weights+"):
            fail("online loop, leg 2: %s export of format %r" % (key, fmt))
        with plain_on():
            t0 = time.perf_counter()
            served = load_servable(base, device=DEVICE)
            load_s = time.perf_counter() - t0
            before = gn.LAUNCHES
            rows[key] = served.predict(images)
            if gn.LAUNCHES - before != GN_PER_FORWARD:
                fail("online loop, leg 2: the %s program launched B1 %d "
                     "times" % (key, gn.LAUNCHES - before))
        if quantize is None:
            census = program_census(torch, vdir)
            if census != {"group_norm_ops": GN_PER_FORWARD,
                          "copies_into_group_norm": 0,
                          "layout_ops_on_weights": 0}:
                fail("online loop, leg 2: the forward program traced on "
                     "the card: %s" % census)
        out[key] = {"export_s": export_s, "trace_s": timed_traces[-1],
                    "load_s": load_s,
                    "npz_bytes": os.path.getsize(
                        os.path.join(vdir, "model.npz")),
                    "program_bytes": os.path.getsize(
                        os.path.join(vdir, "model.pt2"))}
        if quantize is None:
            out[key]["census"] = census
        del served
    if seen[0]:
        fail("online loop, leg 2: %d CUDA tensors reached the plain "
             "GroupNorm" % seen[0])
    out["float32"]["max_rel_err"] = _fleet_check_rows(
        rows["float32"], refs, "online loop, leg 2, float32")
    f32, q8 = rows["float32"], rows["int8"]
    rel = np.abs(q8 - f32).max(axis=1) / np.abs(f32).max(axis=1)
    if not (np.isfinite(q8).all() and rel.max() < INT8_REL_TOL):
        fail("online loop, leg 2: int8 rows off the float32 rows by %s x "
             "max|logit| (limit %g)" % (rel.max(), INT8_REL_TOL))
    out["int8"]["max_rel_err_vs_float32"] = float(rel.max())
    t0 = time.perf_counter()
    load_servable(os.path.join(tmp, "train_end_float32"), device=DEVICE,
                  zoo=("resnet", ONLINE_PARAMS))
    out["zoo_load_s"] = time.perf_counter() - t0
    # The other direction of the manifest's platforms: a program written
    # on the CPU answers on the card as on the CPU.
    small = "variant=resnet_small_cifar10"
    spec = load_model_spec("resnet", small)
    module = spec.init_fn("cpu")
    module.load_state_dict(spec.params_from_jax(
        seeded_params(spec, module, seed=26)))
    cpu_dir = os.path.join(tmp, "cpu_written")
    export_servable(cpu_dir, "resnet", small, module,
                    np.zeros((1, 32, 32, 3), np.float32))
    xs = np.random.RandomState(26).rand(3, 32, 32, 3).astype(np.float32)
    out["cpu_written_max_rel_err"] = _fleet_check_rows(
        load_servable(cpu_dir, device=DEVICE).predict(xs),
        load_servable(cpu_dir, device="cpu").predict(xs),
        "online loop, leg 2, a CPU-written program on the card")
    a, b = out["float32"], out["int8"]
    print("online loop, leg 2: train-end exports at version %d: float32 "
          "%.2f s (trace %.2f s), %d + %d bytes (weights + program), rows "
          "within %.3g x max|logit| of the plain-GN module; int8 %.2f s "
          "(trace %.2f s), %d + %d bytes, rows within %.3g x max|logit| of "
          "float32's (limit %g); load on the card: program route %.2f s "
          "(float32) and %.2f s (int8), zoo route %.2f s; a program "
          "written on the CPU answers on the card within %.3g x "
          "max|logit| of the CPU" % (
              trainer.version, a["export_s"], a["trace_s"], a["npz_bytes"],
              a["program_bytes"], a["max_rel_err"], b["export_s"],
              b["trace_s"], b["npz_bytes"], b["program_bytes"],
              b["max_rel_err_vs_float32"], INT8_REL_TOL, a["load_s"],
              b["load_s"], out["zoo_load_s"],
              out["cpu_written_max_rel_err"]), flush=True)
    return out


def online_phase(torch, gn):
    """The online-learning loop (phase 24); fails past PHASE24_BUDGET_S."""
    from elasticdl_tpu_torch.serving import export as texport
    from elasticdl_tpu_torch.utils import tensor_codec as tc
    from elasticdl_tpu_torch.utils.device import use_float32_numerics

    t0 = time.perf_counter()
    use_float32_numerics()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    timed_traces = []
    trace = texport.trace_servable

    def timed_trace(*args, **kwargs):
        start = time.perf_counter()
        result = trace(*args, **kwargs)
        timed_traces.append(time.perf_counter() - start)
        return result

    texport.trace_servable = timed_trace
    try:
        with tempfile.TemporaryDirectory() as tmp:
            leg1, trainer = online_leg1(torch, gn, tc, tmp, env,
                                        timed_traces)
            out = {"leg1": leg1,
                   "leg2": online_leg2(torch, gn, trainer, tmp,
                                       timed_traces)}
            trainer.close()
            del trainer
    finally:
        texport.trace_servable = trace
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > PHASE24_BUDGET_S:
        fail("online loop: the phase took %.1f s, past its budget of %d s"
             % (out["phase_s"], PHASE24_BUDGET_S))
    return out


# The CTR zoo and the preprocessing library (phase 25).  Leg 1: each
# model of the slice on the PS path, two PS shard processes of its own
# (native Adam, atomic sync): DCN and xDeepFM at phase 22's DeepFM shape
# (bench_deepfm.py:46-48), wide & deep, the census DNN and both census
# SQLFlow variants at their model_spec defaults over synthetic census
# rows, batches of PS_BATCH.  Step 1 on the card against a CPU trainer
# that pulled the same initial parameters, then CTR_WARMUP_STEPS and
# CTR_TIMED_STEPS timed steps.  Leg 2: the collective path on the card:
# wide & deep with its tables local (model_handler.localize_spec), iris
# from an SQLite table through the ``.db`` origin, heart from CSV.
CTR_WARMUP_STEPS = 2
CTR_TIMED_STEPS = 10
# Step 1 on the card against the CPU (float32, TF32 off, the same pulled
# rows): logits and every gradient, dense leaves and pulled rows, within
# the CPU twins' 2e-5 absolute + 1e-5 relative (tests/test_torch_ctr_
# zoo.py); the loss within 1e-5 relative.  Both sum the same float32
# terms in other orders.
CTR_ATOL, CTR_RTOL = 2e-5, 1e-5
CTR_LOSS_RTOL = 1e-5
# Leg 2: the JAX package's own accuracy gates (tests/test_model_zoo.py:88
# for iris, tests/test_heart_and_params.py:24 for heart) and their
# recipes (iris 120 records at batch 32, lr 0.05; heart 256 at batch 64,
# lr 0.02, 10 epochs), but iris trains 20 epochs where its test trains
# 12: from the port's seed-0 init 12 epochs reach 0.842 on the CPU, 20
# reach 0.99 (seeds 0-3 all 0.99).
SMALL_ACCURACY = 0.8
IRIS_EPOCHS = 20
HEART_EPOCHS = 10
LOCAL_STEPS = 10
PHASE25_BUDGET_S = 60


def _ctr_models():
    """(name, spec, records) of each model of leg 1."""
    from elasticdl_tpu_torch.models import (census_dnn, census_sqlflow, dcn,
                                            wide_deep, xdeepfm)

    n = PS_BATCH * PS_BATCHES
    dense, ids, labels = dcn.synthetic_data(
        n=n, num_dense=PS_DENSE, num_fields=PS_FIELDS, vocab_size=PS_VOCAB,
        seed=0)
    ctr = [(dense[i], ids[i], labels[i]) for i in range(n)]
    shape = dict(num_dense=PS_DENSE, num_fields=PS_FIELDS,
                 vocab_size=PS_VOCAB, embedding_dim=PS_DIM, hidden=PS_HIDDEN)
    census = census_dnn.synthetic_census_records(n=n, seed=0)
    return [("dcn", dcn.model_spec(**shape), ctr),
            ("xdeepfm", xdeepfm.model_spec(**shape), ctr),
            ("wide_deep", wide_deep.model_spec(),
             wide_deep.synthetic_census_rows(n=n, seed=0)),
            ("census_dnn", census_dnn.model_spec(), census),
            ("census_sqlflow wide_and_deep",
             census_sqlflow.model_spec("wide_and_deep"), census),
            ("census_sqlflow dnn", census_sqlflow.model_spec("dnn"), census)]


def _ctr_feed(spec, records):
    """The batches of PS_BATCH and the host ms the feed took a batch (the
    preprocessing library: hashing, lookups, buckets, offsets)."""
    t0 = time.perf_counter()
    data = [spec.feed(records[i:i + PS_BATCH])
            for i in range(0, len(records), PS_BATCH)]
    return data, (time.perf_counter() - t0) * 1e3 / len(data)


def _ctr_step1(torch, name, card, cpu, batch):
    """Step 1 on the card against the CPU trainer on the same prepared
    inputs: logits, loss, dense and row gradients; readings or a
    failure."""
    from elasticdl_tpu_torch.worker.ps_trainer import _pad_host_batch

    (features, labels), weights = _pad_host_batch(batch, PS_BATCH)
    feats, emb, _ = card._prepare_embeddings(features)
    got = card.grad_step(feats, labels, weights, emb)
    ref = cpu.grad_step(feats, labels, weights, emb)
    with torch.no_grad():
        logits = [t._spec.apply_fn(t.module, t._inputs(feats, emb, False)[0],
                                   True).cpu() for t in (card, cpu)]
    names = ["logits"] + [n for _, n, _ in card._params] + [
        "rows:" + t for t in sorted(emb)]
    errs, bad = {}, []
    for what, g, r in zip(names, [logits[0]] + got[1] + got[2],
                          [logits[1]] + ref[1] + ref[2]):
        g = g.cpu()
        if not bool(g.isfinite().all()):
            bad.append("%s not finite" % what)
        err = (g - r).abs()
        errs[what] = float(err.max()) if err.numel() else 0.0
        if not bool((err <= CTR_ATOL + CTR_RTOL * r.abs()).all()):
            bad.append("%s (max abs err %.3g)" % (what, errs[what]))
    loss_gap = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    if bad or not loss_gap <= CTR_LOSS_RTOL:
        fail("CTR zoo, leg 1, %s: step 1 on the card against the CPU: loss "
             "%r vs %r (gap %.3g, limit %g); past %g + %g relative: %s" % (
                 name, float(got[0]), float(ref[0]), loss_gap,
                 CTR_LOSS_RTOL, CTR_ATOL, CTR_RTOL, bad))
    return {"loss": float(got[0]), "loss_cpu": float(ref[0]),
            "loss_rel_gap": loss_gap, "max_abs_err": errs,
            "max_abs_err_max": max(errs.values())}


def _ps_embedding_lookup(torch, client, table, dim, ids):
    """PSEmbedding's lookup on the card against a direct pull of the same
    ids: equal rows, on the card."""
    from elasticdl_tpu_torch.models.ps_embedding_callback import PSEmbedding

    emb = PSEmbedding(client, table, dim)
    ids_t = torch.as_tensor(ids, device=DEVICE)
    rows = emb(ids_t, emb.handle)
    want = client.pull_embedding_vectors(table, np.asarray(ids), dim=dim)
    if (rows.device.type != torch.device(DEVICE).type
            or not rows.requires_grad
            or not np.array_equal(rows.detach().cpu().numpy(), want)):
        fail("CTR zoo, leg 1: PSEmbedding's lookup on %s is not the direct "
             "pull's rows" % rows.device)
    return {"ids": int(ids_t.numel()), "table": table}


def ctr_ps_leg(torch, env, tmp):
    """Leg 1 of phase 25 (see CTR_WARMUP_STEPS)."""
    from elasticdl_tpu_torch.utils.device import use_float32_numerics
    from elasticdl_tpu_torch.utils.retry import ps_rpc_policy
    from elasticdl_tpu_torch.worker.ps_client import build_ps_client
    from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer

    use_float32_numerics()
    models = _ctr_models()
    t0 = time.perf_counter()
    fleets = [_Shards(2, spec.ps_optimizer, False, env, tmp,
                      "ctr%d" % i) for i, (_, spec, _) in enumerate(models)]
    out, local_ref = {}, None
    try:
        for fleet, (name, spec, records) in zip(fleets, models):
            data, feed_ms = _ctr_feed(spec, records)
            client = build_ps_client(fleet.addrs, retry=ps_rpc_policy())
            card = ParameterServerTrainer(spec, client, PS_BATCH,
                                          atomic_sync=True, rng_seed=0,
                                          device=DEVICE)
            cpu = ParameterServerTrainer(
                spec, build_ps_client(fleet.addrs), PS_BATCH,
                atomic_sync=True, rng_seed=1, device="cpu")
            same = all(np.array_equal(a, b) for a, b in zip(
                card.export_parameters().values(),
                cpu.export_parameters().values()))
            if not same or card.device.type != torch.device(DEVICE).type:
                fail("CTR zoo, leg 1, %s: the CPU trainer's parameters are "
                     "not the card trainer's pushed ones (or the card "
                     "trainer is on %s)" % (name, card.device))
            step1 = _ctr_step1(torch, name, card, cpu, data[0])
            cpu.close()
            timed = _ps_timed(torch, card, data, "CTR zoo, " + name,
                              warmup=CTR_WARMUP_STEPS,
                              steps=CTR_TIMED_STEPS)
            out[name] = dict(step1=step1, feed_ms=feed_ms, **timed)
            if name == "dcn":
                out["ps_embedding_lookup"] = _ps_embedding_lookup(
                    torch, client, spec.ps_embedding_infos[0]["name"],
                    PS_DIM, data[0][0]["__ids__"][
                        spec.ps_embedding_infos[0]["name"]][:64].ravel())
            if name == "wide_deep":
                local_ref = _local_reference(card, client, spec, data[0])
            card.close()
    except BaseException:
        for f in fleets:
            print(f.tail(), file=sys.stderr)
        raise
    finally:
        for f in fleets:
            f.stop()
    out["shards_and_models_s"] = time.perf_counter() - t0
    return out, local_ref


def _local_reference(card, client, spec, batch):
    """wide & deep's PS form at the end of its timed steps: the dense
    parameters and the whole tables pulled from the PS, and the card
    trainer's loss on ``batch`` over them (leg 2 holds the localized
    spec's first loss against it)."""
    from elasticdl_tpu_torch.models.wide_deep import build_feed
    from elasticdl_tpu_torch.worker.ps_trainer import _pad_host_batch

    card.drain_pushes()
    card._pull_dense()
    (features, labels), weights = _pad_host_batch(batch, PS_BATCH)
    feats, emb, _ = card._prepare_embeddings(features)
    loss = float(card.grad_step(feats, labels, weights, emb)[0])
    vocab = build_feed()[1]
    tables = {i["name"]: client.pull_embedding_vectors(
        i["name"], np.arange(vocab), dim=i["dim"])
        for i in spec.ps_embedding_infos}
    return {"loss": loss, "dense": card.export_parameters(),
            "tables": tables, "vocab": vocab}


def _accuracy(trainer, spec, records, batch, binary):
    xs, ys = spec.feed(records)
    correct = 0
    for i in range(0, len(records), batch):
        out, labels = trainer.evaluate_minibatch(xs[i:i + batch],
                                                 ys[i:i + batch])
        pred = (out > 0) if binary else np.argmax(out, -1)
        correct += int((pred == labels).sum())
    return correct / len(records)


def _train_small(torch, spec, reader, epochs, batch, binary, what):
    """Train ``spec`` on the card from every record ``reader`` holds
    through CollectiveTrainer; returns its readings (fails below
    SMALL_ACCURACY)."""
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    task = SimpleNamespace(shard=SimpleNamespace(
        start=0, end=reader.get_size(), record_indices=[]))
    records = [list(r) for r in reader.read_records(task)]
    trainer = CollectiveTrainer(spec, batch_size=batch, device=DEVICE)
    t0 = time.perf_counter()
    losses = []
    for _ in range(epochs):
        for i in range(0, len(records), batch):
            xs, ys = spec.feed(records[i:i + batch])
            losses.append(trainer.train_minibatch(xs, ys)[0])
    losses = [float(x) for x in losses]
    train_s = time.perf_counter() - t0
    acc = _accuracy(trainer, spec, records, batch, binary)
    device = next(trainer._module.parameters()).device
    if (not all(map(math.isfinite, losses)) or not acc > SMALL_ACCURACY
            or device.type != torch.device(DEVICE).type):
        fail("CTR zoo, leg 2, %s: accuracy %.3f (needs > %g) on %s, "
             "losses %s" % (what, acc, SMALL_ACCURACY,
                            next(trainer._module.parameters()).device,
                            losses[::8]))
    return {"records": len(records), "epochs": epochs, "accuracy": acc,
            "loss_first": losses[0], "loss_last": losses[-1],
            "steps": len(losses), "train_s": train_s}


def ctr_collective_leg(torch, local_ref, tmp):
    """Leg 2 of phase 25 (see CTR_WARMUP_STEPS)."""
    from elasticdl_tpu_torch.data.factory import create_data_reader
    from elasticdl_tpu_torch.data.sql_reader import SQLTableWriter
    from elasticdl_tpu_torch.models import heart, iris, wide_deep
    from elasticdl_tpu_torch.models.model_handler import localize_spec
    from elasticdl_tpu_torch.worker.collective_trainer import (
        CollectiveTrainer)

    # wide & deep, its tables local, from the PS form's final state.
    spec = localize_spec(wide_deep.model_spec(), {
        t: local_ref["vocab"] for t in local_ref["tables"]})
    if spec.ps_embedding_infos:
        fail("CTR zoo, leg 2: wide & deep's tables were not all localized")
    trainer = CollectiveTrainer(spec, batch_size=PS_BATCH, device=DEVICE)
    trainer._module.load_state_dict(spec.params_from_jax(dict(
        local_ref["dense"], **{"local_emb__" + t: v
                               for t, v in local_ref["tables"].items()})))
    rows = wide_deep.synthetic_census_rows(n=PS_BATCH * PS_BATCHES, seed=0)
    data = [spec.feed(rows[i:i + PS_BATCH])
            for i in range(0, len(rows), PS_BATCH)]
    losses = [float(trainer.train_minibatch(*data[s % len(data)])[0])
              for s in range(LOCAL_STEPS)]
    gap = abs(losses[0] - local_ref["loss"]) / abs(local_ref["loss"])
    if not gap <= CTR_LOSS_RTOL or not losses[-1] < losses[0]:
        fail("CTR zoo, leg 2: wide & deep localized, first loss %r against "
             "the PS form's %r on the same tables (gap %.3g, limit %g), "
             "losses %s" % (losses[0], local_ref["loss"], gap,
                            CTR_LOSS_RTOL, losses))
    out = {"wide_deep_local": {
        "loss_first": losses[0], "loss_ps_form": local_ref["loss"],
        "loss_rel_gap": gap, "loss_last": losses[-1],
        "table_rows": local_ref["vocab"], "steps": LOCAL_STEPS}}
    # iris from an SQLite table through the ".db" origin.
    db = os.path.join(tmp, "iris.db")
    csv = iris.synthetic_iris_csv(os.path.join(tmp, "iris.csv"), n=120)
    with open(csv) as f:
        table = [[float(v) for v in line.strip().split(",")] for line in f]
    writer = SQLTableWriter(db, "samples", ["f0", "f1", "f2", "f3", "label"])
    writer.write(table)
    writer.close()
    out["iris_sql"] = _train_small(
        torch, iris.model_spec(learning_rate=0.05),
        create_data_reader(db, records_per_shard=32), IRIS_EPOCHS, 32, False,
        "iris from SQLite")
    # heart from CSV.
    csv = heart.synthetic_heart_csv(os.path.join(tmp, "heart.csv"), n=256)
    out["heart_csv"] = _train_small(
        torch, heart.model_spec(learning_rate=0.02),
        create_data_reader(csv, records_per_shard=64), HEART_EPOCHS, 64,
        True,
        "heart from CSV")
    return out


def ctr_phase(torch, fa, gn):
    """The CTR zoo and the preprocessing library (module docstring, phase
    25); fails past PHASE25_BUDGET_S."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    zero_flash_counts(fa)
    gn.LAUNCHES = gn.BWD_LAUNCHES = fa.PARTIAL_LAUNCHES = 0
    tmp = tempfile.TemporaryDirectory()
    try:
        out, local_ref = ctr_ps_leg(torch, env, tmp.name)
        out["collective"] = ctr_collective_leg(torch, local_ref, tmp.name)
    finally:
        tmp.cleanup()
    out["launches"] = {
        "group_norm_fwd": gn.LAUNCHES, "group_norm_bwd": gn.BWD_LAUNCHES,
        "flash_attention_fwd": fa.LAUNCHES,
        "flash_attention_partial_fwd": fa.PARTIAL_LAUNCHES,
        "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES,
        "flash_attention_bwd_dkv": fa.BWD_DKV_LAUNCHES}
    if any(out["launches"].values()):
        fail("CTR zoo: the phase launched kernels of ops/: %s"
             % out["launches"])
    out["phase_s"] = time.perf_counter() - t0
    smi = nvidia_smi_line()
    for name, r in out.items():
        if not isinstance(r, dict) or "steps_per_s" not in r:
            continue
        print("CTR zoo, leg 1 (%s, batch %d, Adam on 2 PS shards, atomic "
              "sync; %s): %.1f steps/s (%.2f ms a step over %d steps); ms "
              "a step: dense pull %.3f, embedding pull %.3f (%.1f pulls), "
              "device step %.3f, push %.3f, other host work %.3f; feed "
              "(preprocessing) %.2f ms a batch; loss %.4f -> %.4f; step 1 "
              "against the CPU: loss gap %.3g, worst abs error %.3g" % (
                  name, PS_BATCH, smi, r["steps_per_s"], r["step_ms"],
                  CTR_TIMED_STEPS, r["ms"]["dense_pull"],
                  r["ms"]["embedding_pull"], r["embedding_pulls_per_step"],
                  r["ms"]["device_step"], r["ms"]["push"], r["ms"]["other"],
                  r["feed_ms"], r["losses"][0], r["losses"][-1],
                  r["step1"]["loss_rel_gap"], r["step1"]["max_abs_err_max"]))
    coll = out["collective"]
    local = coll["wide_deep_local"]
    print("CTR zoo, leg 2 (collective path on the card; %s): wide & deep "
          "with its 2 tables local (%d rows each): first loss %.7f against "
          "the PS form's %.7f on the same tables (gap %.3g), %.4f after %d "
          "steps; iris from SQLite (.db origin, %d records) accuracy %.3f; "
          "heart from CSV (%d records) accuracy %.3f; PSEmbedding's lookup "
          "on the card equals a direct pull (%d ids); ops/ kernels "
          "launched: none; phase %.1f s" % (
              smi, local["table_rows"], local["loss_first"],
              local["loss_ps_form"], local["loss_rel_gap"],
              local["loss_last"], local["steps"],
              coll["iris_sql"]["records"], coll["iris_sql"]["accuracy"],
              coll["heart_csv"]["records"], coll["heart_csv"]["accuracy"],
              out["ps_embedding_lookup"]["ids"], out["phase_s"]))
    if out["phase_s"] > PHASE25_BUDGET_S:
        fail("CTR zoo: the phase took %.1f s, past its budget of %d s"
             % (out["phase_s"], PHASE25_BUDGET_S))
    return out


# Phase 26: the control plane (ROADMAP A14, A19, A20).  Leg 1, the port's
# CLI (``python -m elasticdl_tpu_torch.client.main train --platform local
# --jobs_spec``) runs a pool of two workers on the card over two jobs: mnist
# on CP_MNIST_RECORDS records and ResNet-50 at its full widths
# (resnet50_cifar10 on synthetic_cifar10, phase 18's CLI job) on
# CP_RESNET_RECORDS, batch 32, each job 1 to 2 workers; the resize
# controller moves the mnist job's worker to ResNet-50 once mnist is done,
# and the worker rebuilds its pipeline in place.  Leg 2, ``inspect`` on the
# ResNet-50 job's checkpoints and on phase 5's export.  Leg 3, ``train
# --platform k8s --output -`` renders the cluster submission, and the port's
# K8sWorkerBackend the worker pod the in-cluster master would create from
# it; no cluster is contacted.
PHASE26_BUDGET_S = 60
CP_MNIST_RECORDS = 512
CP_RESNET_RECORDS = 2048
CP_BATCH = 32
CP_MINIBATCHES = 4
CP_CHECKPOINT_STEPS = 8        # worker 0 writes the ResNet-50 job's
CP_TIMEOUT_S = 50
CP_GPU_REQUEST = "cpu=4,memory=16Gi,nvidia.com/gpu=1"
# What a switched worker still holds on the card when the new job's trainer
# build starts: the Worker has dropped the old trainer and pipeline.  The
# smallest trainer it can drop, mnist's, holds 1.7 MB of float32 parameters.
CP_LEFTOVER_BYTES = 1 << 20


def _cp_steps_by_job(lines):
    """{job: [host times of its workers' step logs]} and {worker: job},
    following each worker's ``switched to job`` lines."""
    current, steps = {}, {}
    step_re = re.compile(r"\[worker-(\d+)\] .* step \d+ loss (\S+) ")
    for t, line in lines:
        m = re.search(r"\[worker-(\d+)\] .*switched to job (\w+)", line)
        if m:
            current[m.group(1)] = m.group(2)
            continue
        m = step_re.search(line)
        if m:
            steps.setdefault(current.get(m.group(1)), []).append(
                (t, float(m.group(2))))
    return steps


def control_plane_pool_leg(torch, tmp):
    """Leg 1 of phase 26; returns its numbers."""
    from elasticdl_tpu_torch.master.journal import journal_path, scan_frames
    from elasticdl_tpu_torch.models.spec import load_model_spec

    env = _worker_env()
    ckpt, jdir = os.path.join(tmp, "ckpt_b"), os.path.join(tmp, "journal")
    jobs = [
        {"name": "jobA", "model_zoo": "mnist",
         "data_origin": "synthetic_mnist:%d" % CP_MNIST_RECORDS,
         "min_workers": 1, "max_workers": 2},
        {"name": "jobB", "model_zoo": "resnet",
         "model_params": "variant=resnet50_cifar10",
         "data_origin": "synthetic_cifar10:%d" % CP_RESNET_RECORDS,
         "checkpoint_dir": ckpt, "min_workers": 1, "max_workers": 2},
    ]
    spec_path = os.path.join(tmp, "jobs.json")
    with open(spec_path, "w") as f:
        json.dump(jobs, f)
    status_port = _free_port()
    args = ["train", "--platform", "local", "--jobs_spec", spec_path,
            "--num_workers", "2", "--batch_size", str(CP_BATCH),
            "--num_minibatches_per_task", str(CP_MINIBATCHES),
            "--sched_cadence_secs", "0.5", "--status_port", str(status_port),
            "--journal_dir", jdir,
            "--checkpoint_steps", str(CP_CHECKPOINT_STEPS),
            "--log_loss_steps", "1"]
    what = "control plane, leg 1"
    job = _MasterProcess(args, env, tmp, what=what,
                         module="elasticdl_tpu_torch.client.main")
    deadline = job.t0 + CP_TIMEOUT_S
    pids, running_both, states = {}, [], []
    try:
        # /status and the pool's pids while the jobs run.
        while job.proc.poll() is None and time.perf_counter() < deadline:
            pids.update(job.worker_pids())
            code, body = _get_json(status_port, "/status")
            if code == 200:
                now = {name: j.get("state")
                       for name, j in body.get("jobs", {}).items()}
                states.append(now)
                if now == {"jobA": "running", "jobB": "running"}:
                    running_both.append(time.perf_counter() - job.t0)
            time.sleep(0.1)
        try:
            rc = job.proc.wait(timeout=max(1.0, deadline
                                           - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail("%s: the pool did not finish within %d s; its tail:\n%s"
                 % (what, CP_TIMEOUT_S, job.tail()))
        t_end = time.perf_counter()
    finally:
        job.stop()
    log = "".join(line for _, line in job.lines)
    if rc != 0 or not re.search(r"all jobs finished", log):
        fail("%s: rc %s; tail:\n%s" % (what, rc, job.tail()))
    launched = re.findall(r"launched worker (\d+)", log)
    if (sorted(pids.values()) != [0, 1] or sorted(launched) != ["0", "1"]
            or "relaunch=True" in log):
        fail("%s: worker processes {pid: id} %s, launched %s: a worker "
             "restarted" % (what, pids, launched))
    if not running_both:
        fail("%s: /status never listed both jobs running: %s"
             % (what, states[:5]))

    # Every record of each job once, from its own journal.
    accounted = {}
    for job_id, spec in enumerate(jobs, start=1):
        with open(journal_path(os.path.join(jdir, "job-%02d" % job_id)),
                  "rb") as f:
            recs = [r for r, _ in scan_frames(f.read())]
        records = int(spec["data_origin"].split(":")[1])
        tasks = sorted(r["id"] for r in recs if r["ev"] == "task")
        done = sorted(r["id"] for r in recs if r["ev"] == "done")
        batched = sum(r["n"] for r in recs if r["ev"] == "batch")
        failed = [r for r in recs if r["ev"] == "fail"]
        if (done != tasks or len(tasks) != records // (CP_BATCH
                                                       * CP_MINIBATCHES)
                or batched != records or failed):
            fail("%s: %s's journal: tasks %s, done %s, %d records in "
                 "batches of %d, failures %s" % (
                     what, spec["name"], tasks, done, batched, records,
                     failed[:3]))
        accounted[spec["name"]] = {"tasks": len(tasks), "records": batched}
    with open(journal_path(os.path.join(jdir, "sched")), "rb") as f:
        moves = [r for r, _ in scan_frames(f.read())
                 if r.get("ev") == "sched" and r.get("op") == "assign"
                 and r.get("prev")]
    if not moves or (moves[0]["prev"], moves[0]["job"]) != (1, 2):
        fail("%s: the controller moved no worker from jobA to jobB: %s"
             % (what, moves))
    t_move, _ = job.wait_for(r"resize: worker \d+ moved jobA -> jobB",
                             t_end)

    # B1 and B2: 53 a pass in every trainer of the ResNet-50 job, the
    # moved worker's among them.
    launches, passes_b = {}, {}
    for w in ("0", "1"):
        m = re.search(r"\[worker-%s\] .*kernel launches: (\{.*\})" % w, log)
        if not m:
            fail("%s: worker %s logged no kernel launches" % (what, w))
        counts = json.loads(m.group(1))
        launches[w] = counts
        for row in counts["by_trainer"]:
            if row["job"] != "jobB":
                if row["group_norm_fwd"] or row["group_norm_bwd"]:
                    fail("%s: worker %s launched GroupNorm for %s: %s"
                         % (what, w, row["job"], row))
                continue
            n = row["train_passes"]
            if not (row["group_norm_fwd"] == row["group_norm_bwd"]
                    == GN_PER_FORWARD * n):
                fail("%s: worker %s's ResNet-50 trainer launched %s over "
                     "%d passes, want B1 and B2 %d a pass" % (
                         what, w, row, n, GN_PER_FORWARD))
            passes_b[w] = passes_b.get(w, 0) + n
    moved = str(moves[0]["w"])
    if not passes_b.get(moved) or sum(passes_b.values()) < (
            CP_RESNET_RECORDS // CP_BATCH):
        fail("%s: ResNet-50 passes by worker %s, the moved worker %s: "
             "every one must have trained it" % (what, passes_b, moved))

    # The switch into ResNet-50: the old trainer gone from the card before
    # the new one was built, whose parameters are on the card.
    n_params = sum(p.numel() for p in load_model_spec(
        "resnet", "variant=resnet50_cifar10").init_fn("cpu").parameters())
    switches = [(int(a), int(b)) for a, b in re.findall(
        r"job switch to jobB: (\d+) bytes allocated on cuda\S* before its "
        r"trainer was built, (\d+) after", log)]
    if (len(switches) != len(passes_b) or any(
            before >= CP_LEFTOVER_BYTES or after - before < 4 * n_params
            for before, after in switches)):
        fail("%s: device bytes at the switches into jobB (before the "
             "build, after) %s; want under %d before and %d more after"
             % (what, switches, CP_LEFTOVER_BYTES, 4 * n_params))
    steps = _cp_steps_by_job(job.lines)
    losses_b = [loss for _, loss in steps.get("jobB", [])]
    if not losses_b or not all(map(math.isfinite, losses_b)):
        fail("%s: jobB's losses %s" % (what, losses_b[:10]))
    rates = {name: _rate(sorted(t for t, _ in steps.get(name, [])))
             for name in ("jobA", "jobB")}
    return {"rc": rc, "job_s": t_end - job.t0,
            "first_move_s": t_move - job.t0, "moves": len(moves),
            "moved_worker": moved, "steps_per_s": rates,
            "steps": {k: len(v) for k, v in steps.items() if k},
            "accounted": accounted, "launches": launches,
            "resnet_passes": passes_b, "switch_bytes": switches,
            "resnet_params": n_params,
            "loss_b": [losses_b[0], losses_b[-1]],
            "status_polls": len(states), "checkpoint_dir": ckpt}


def _cli_stdout(argv):
    """(exit code, standard output) of the port's CLI run in process."""
    import io

    from elasticdl_tpu_torch.client import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue()


def control_plane_inspect_leg(ckpt, export_base):
    """Leg 2 of phase 26: ``inspect`` on the pool's checkpoints and on
    phase 5's export."""
    out = {}
    for name, path, want in (
            ("checkpoint", ckpt, ("checkpoint dir:", "latest loadable: "
                                  "version")),
            ("export", export_base, ("servable export:", "program: "
                                     "model.pt2", "parameters:"))):
        rc, text = _cli_stdout(["inspect", path])
        if rc != 0 or not all(w in text for w in want):
            fail("control plane, leg 2: inspect %s exited %s:\n%s"
                 % (name, rc, text))
        out[name] = text.strip().splitlines()
    return out


def control_plane_submission_leg():
    """Leg 3 of phase 26: the rendered submission and the worker pod."""
    from elasticdl_tpu_torch.master.main import (
        _MASTER_ONLY_ARGS,
        _build_worker_backend,
    )
    from elasticdl_tpu_torch.utils.args import (
        build_arguments_from_parsed_result,
        parse_master_args,
    )

    what = "control plane, leg 3"
    rc, text = _cli_stdout([
        "train", "--platform", "k8s", "--output", "-", "--job_name",
        "resnet50-pool", "--image", "elasticdl-tpu-torch:cu128",
        "--model_zoo", "resnet", "--model_params",
        "variant=resnet50_cifar10", "--num_workers", "2",
        "--worker_resource_request", CP_GPU_REQUEST])
    docs = [json.loads(d) for d in text.split("---\n") if d.strip()]
    if rc != 0 or [d["kind"] for d in docs] != ["Pod", "Service"]:
        fail("%s: rc %s, documents %s" % (what, rc, text[:300]))
    container = docs[0]["spec"]["containers"][0]
    margs = container["args"]
    if (container["command"] != ["python", "-m",
                                 "elasticdl_tpu_torch.master.main"]
            or margs[margs.index("--worker_backend") + 1] != "k8s"):
        fail("%s: the master pod runs %s with %s" % (
            what, container["command"], margs))
    # What the in-cluster master builds from those args.
    args = parse_master_args(margs)
    backend = _build_worker_backend(args, build_arguments_from_parsed_result(
        args, filter_args=_MASTER_ONLY_ARGS))
    pod = backend.pod_manifest(0, "resnet50-pool-master.default.svc:50001")
    worker = pod["spec"]["containers"][0]
    if (worker["command"][-1] != "elasticdl_tpu_torch.worker.main"
            or worker["resources"].get("limits") != {"nvidia.com/gpu": "1"}
            or worker["resources"]["requests"].get("nvidia.com/gpu") != "1"
            or backend._core_api is not None):
        fail("%s: the worker pod %s" % (what, json.dumps(worker)))
    return {"master_command": container["command"],
            "worker_command": worker["command"],
            "worker_resources": worker["resources"],
            "service_ports": docs[1]["spec"]["ports"]}


def control_plane_phase(torch, export_base):
    """The control plane (module docstring, phase 26); fails past
    PHASE26_BUDGET_S."""
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    try:
        out = {"pool": control_plane_pool_leg(torch, tmp.name)}
        out["inspect"] = control_plane_inspect_leg(
            out["pool"]["checkpoint_dir"], export_base)
        out["pool"]["checkpoint_dir"] = os.path.basename(
            out["pool"]["checkpoint_dir"])
    finally:
        tmp.cleanup()
    out["submission"] = control_plane_submission_leg()
    out["phase_s"] = time.perf_counter() - t0
    pool = out["pool"]
    smi = nvidia_smi_line()
    print("control plane, leg 1 (the port's CLI, --jobs_spec, a pool of 2 "
          "workers on the card; %s): mnist %d records and resnet50_cifar10 "
          "%d records, batch %d; exit 0 in %.1f s, the first move (jobA -> "
          "jobB, worker %s) %.2f s after the start, %d move(s), no worker "
          "restarts; steps/s jobA %s, jobB %s (%s steps); ResNet-50 passes "
          "by worker %s, B1 and B2 53 a pass in each (launches %s); device "
          "bytes at the switches into jobB, before the build and after: "
          "%s (%d parameters); jobB loss %.4f -> %.4f; /status polled %d "
          "times, both jobs running" % (
              smi, CP_MNIST_RECORDS, CP_RESNET_RECORDS, CP_BATCH,
              pool["job_s"], pool["moved_worker"], pool["first_move_s"],
              pool["moves"], pool["steps_per_s"]["jobA"],
              pool["steps_per_s"]["jobB"], pool["steps"],
              pool["resnet_passes"], json.dumps(pool["launches"]),
              pool["switch_bytes"], pool["resnet_params"], *pool["loss_b"],
              pool["status_polls"]))
    for name, lines in out["inspect"].items():
        print("control plane, leg 2: inspect %s:\n  %s" % (
            name, "\n  ".join(lines)))
    sub = out["submission"]
    print("control plane, leg 3: train --platform k8s --output - renders a "
          "master pod running %s (--worker_backend k8s) and a Service on %s; "
          "its worker pod runs %s with resources %s; phase %.1f s" % (
              " ".join(sub["master_command"]), sub["service_ports"],
              " ".join(sub["worker_command"]),
              json.dumps(sub["worker_resources"]), out["phase_s"]))
    if out["phase_s"] > PHASE26_BUDGET_S:
        fail("control plane: the phase took %.1f s, past its budget of %d "
             "s" % (out["phase_s"], PHASE26_BUDGET_S))
    return out


def import_export_machinery():
    import torch._dynamo  # noqa: F401
    import torch._export.serde.serialize  # noqa: F401
    import torch._subclasses.fake_tensor  # noqa: F401
    import torch.export.passes  # noqa: F401


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
    # torch.export's machinery (torch._dynamo, sympy, the serializer) is
    # imported once, beside the kernel build, not by the first phase
    # that makes a fake tensor or loads a program.
    machinery = threading.Thread(target=import_export_machinery,
                                 daemon=True)
    machinery.start()
    outputs = build.build_all()
    machinery.join()
    build_s = time.perf_counter() - t0
    for name, text in outputs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print("nvcc %s: %s" % (name, line.strip()))
    print("build: %d kernel sources in %.1f s" % (len(outputs), build_s))

    phase_s = {"build": build_s}
    print("phase build: %.1f s" % build_s, flush=True)

    def run(name, fn, *fn_args):
        """Run one phase; its seconds go into phase_s and on a line of
        their own as it ends."""
        t0 = time.perf_counter()
        result = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        print("phase %s: %.1f s" % (name, phase_s[name]), flush=True)
        return result

    rows, max_err, totals = run("forward kernel", kernel_phase, torch, gn)
    for (batch, name, _), tot in zip(GN_TIMED, totals.values()):
        print("kernel per ResNet-50 forward at batch %d (53 calls, %s): "
              "kernel %.4f ms, plain %.4f ms, F.group_norm %.4f ms, bound "
              "%.4f ms (%s), %.1f %% of the bound" % (
                  batch, name, tot["ms"], tot["plain_ms"],
                  tot["library_ms"], tot["bound_ms"], tot["bound_by"],
                  100 * tot["share_of_bound"]))
    bwd_rows, bwd_err, bwd_totals = run("backward kernel", backward_phase,
                                        torch, gn)
    for (batch, name, _), tot in zip(GN_TIMED, bwd_totals.values()):
        print("backward kernel per ResNet-50 step at batch %d (53 calls, "
              "%s): kernel %.4f ms, plain %.4f ms, F.group_norm backward "
              "%.4f ms, bound %.4f ms (%s), %.1f %% of the bound" % (
                  batch, name, tot["ms"], tot["plain_ms"],
                  tot["library_ms"], tot["bound_ms"], tot["bound_by"],
                  100 * tot["share_of_bound"]))

    # Phase 5's export, inspected by phase 26.
    kept = tempfile.TemporaryDirectory()
    module, serve_launches, latencies, serve_err = run(
        "serving", serving_phase, torch, gn, kept.name)
    forward = run("forward", forward_phase, torch, gn, module)
    del module
    train = run("training", training_phase, torch, gn)
    flash_err, flash_timed = run("flash kernel", flash_phase, torch, fa)
    # Exports of the LM phases: the dense LM's stays for the LoRA phase.
    exports = tempfile.TemporaryDirectory()
    try:
        lm = run("transformer serving", transformer_phase, torch, fa,
                 exports.name)
        flash_bwd_err, bwd_timed = run("flash backward kernels",
                                       flash_bwd_phase, torch, fa)
        lm_train = run("transformer training", lm_training_phase, torch, fa)
        moe = run("moe serving", moe_serving_phase, torch, fa, exports.name)
        moe_train = run("moe training", moe_training_phase, torch, fa)
        remat = run("remat policies", remat_phase, torch, fa)
        lora_out = run("lora", lora_phase, torch, fa, lm["export_dir"])
    finally:
        exports.cleanup()
    refs = run("multi-rank references", multi_rank_refs, torch, fa)
    # Phase 17's killed-master drill runs beside phase 16's worlds.
    master_kill = Beside(master_kill_leg, torch)
    sp = run("sequence parallelism", sp_phase, torch, fa, refs, master_kill)
    proc = run("process path", process_phase, torch, fa, master_kill)
    coll = run("collective path", collective_phase, torch)
    zero = run("ZeRO-1 path", zero1_phase, torch)
    clm = run("collective LM", collective_lm_phase, torch, refs)
    del refs
    jobs = run("MobileNetV2, job types, surfaces", jobs_phase, torch, gn)
    ps = run("PS path, DeepFM", ps_phase, torch, fa, gn)
    fleet = run("serving fleet", fleet_phase, torch, gn)
    online = run("online loop", online_phase, torch, gn)
    ctr = run("CTR zoo and preprocessing", ctr_phase, torch, fa, gn)
    try:
        control = run("control plane", control_plane_phase, torch,
                      os.path.join(kept.name, "resnet50"))
    finally:
        kept.cleanup()
    print("CTR zoo beside DeepFM: phase 22's DeepFM on the same shards' "
          "path, atomic sync, %.1f steps/s; phase 25: %s" % (
              ps["trainer"]["timed"]["atomic sync"]["steps_per_s"],
              ", ".join("%s %.1f" % (name, r["steps_per_s"])
                        for name, r in ctr.items()
                        if isinstance(r, dict) and "steps_per_s" in r)))
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
        "launches_a4c_mesh_step_per_rank":
            zero["ranks"]["mesh_leg"]["launches"][0],
        "launches_master_kill_drill": {
            w: c["group_norm_fwd"]
            for w, c in proc["master_kill"]["launches"].items()},
        "launches_predict_job": jobs["jobs"]["launches_predict_job"],
        "launches_serving_fleet": {
            "total": fleet["leg1"]["batched"]["launches"],
            "per_batch": GN_PER_FORWARD,
            "batches": fleet["leg1"]["batched"]["batches"],
            "warmed_buckets": FLEET_BUCKETS,
            "per_serialized_request": GN_PER_FORWARD},
        "launches_control_plane_pool": {
            w: c["by_trainer"]
            for w, c in control["pool"]["launches"].items()},
        "launches_online_loop": {
            "by_the_program": online["leg1"]["program_launches"],
            "per_batch": GN_PER_FORWARD,
            "batches": online["leg1"]["batches"],
            "warmed_buckets": FLEET_BUCKETS},
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
        "launches_a4c_mesh_step_per_rank":
            zero["ranks"]["mesh_leg"]["launches"][1],
        "launches_master_kill_drill": {
            w: c["group_norm_bwd"]
            for w, c in proc["master_kill"]["launches"].items()},
        "launches_control_plane_pool": {
            w: c["by_trainer"]
            for w, c in control["pool"]["launches"].items()},
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
        "launches_a18_step_per_rank": a18_launch_counts(sp, 0),
        "launches_a12b_per_batch": {
            "dense": lm["batched"]["b3_launches_per_batch"],
            "moe": moe["batched"]["b3_launches_per_batch"]},
        "launches_lora_cli_job": {
            w: c["flash_fwd"]
            for w, c in clm["lora_cli"]["launches"].items()},
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
            "launches_a18_step_per_rank": a18_launch_counts(sp, 2 + i),
            "launches_lora_cli_job": {
                w: c["flash_bwd_" + part]
                for w, c in clm["lora_cli"]["launches"].items()},
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
        "library_ms": part[("bfloat16", True)]["library_ms"],
        "library_is": "aten._scaled_dot_product_flash_attention at the "
                      "same q, k, v: its normalised output and log-sum-exp "
                      "carry (acc, l, m) with m = lse and l = 1",
        "times_are": "one call at the sp=2 ring's diagonal block, q, k, v "
                     "[8, 16, 1024, 64] bfloat16, causal (the launch "
                     "elasticdl_tpu/ops/flash_attention.py:225 with "
                     "normalize=False); launches in one training step of "
                     "the flagship LM at sp=2, summed over the two ranks",
        "noncausal": {key: part[("bfloat16", False)][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "float32": {key: part[("float32", True)][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
    })
    for row in kernels:
        # Phase 22's count over its DeepFM steps (it fails unless 0).
        row["launches_deepfm_ps"] = ps["trainer"]["launches"][row["name"]]
        # Phase 25's count over the CTR zoo's steps (it fails unless 0).
        row["launches_ctr_zoo"] = ctr["launches"][row["name"]]
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
                       "ps_path": ps,
                       "serving_fleet": fleet,
                       "online_loop": online,
                       "ctr_zoo": ctr,
                       "control_plane": control,
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
