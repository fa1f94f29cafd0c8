#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA card
and check it end to end.  Run from the root of a checkout:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:

 1. device: the card's name and power limit (nvidia-smi);
 2. build: every kernel in elasticdl_tpu_torch/ops/csrc/, with nvcc;
 3. kernel against plain: the GroupNorm kernel against its plain
    PyTorch version on the card at every GroupNorm shape of ResNet-50,
    at the served batch (4) and at batch 32, float32 and bfloat16, ReLU
    off and on, plus a large-mean case; then, at batch 32 and per shape,
    the kernel's time, the plain version's, F.group_norm's (a yardstick
    the port never calls) and the bound;
 4. end to end: a seeded ResNet-50 (224x224x3 in, 1000 classes) is
    exported with the port's exporter, served by the port's HTTP server
    on the card, and answers three :predict requests of four images;
    predictions must match the same module run with the plain GroupNorm,
    and the kernel must have launched 53 times per forward;
 5. forward: the served module's forward at batch 4 and 32 with the
    kernel and with the plain GroupNorm, in turns;
 6. one JSON line of kernels, then the card's name and power limit, then
    {"ok": true, "device": {...}} as the last line.

Tolerances (|got - ref| <= atol + rtol * |ref|):
 - kernel vs plain, float32: 2e-5 / 2e-5, the JAX package's own forward
   tolerance (the two reduce in f32 in different orders);
 - kernel vs plain, bfloat16: 3e-2 / 3e-2 (both round the same f32 value
   to bf16; a value near a rounding boundary may land one bf16 ulp,
   2^-7 relative at most, apart);
 - mean and rstd, both dtypes: 2e-5 / 2e-5 (f32 statistics);
 - large mean (1e4 + N(0, 1)), float32, against float64: 1e-2 / 1e-2,
   as the JAX package's stability test;
 - served logits vs the plain-GroupNorm module: 1e-3 * max|logit|
   absolute.  Convs run in float32 with TF32 off on both sides; the GN
   outputs differ by f32 rounding, carried through 53 layers.
"""

import argparse
import contextlib
import http.client
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

BATCH = 32                     # the kernel table's batch
SERVE_BATCH = 4                # images per :predict request
REQUESTS = 3
GROUPS = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside tensor cores
SPIN_CYCLES = 2_000_000        # about 1 ms at the H100's clock
FLOPS_PER_ELEMENT = 7          # stats: sub, add, fma; normalize: fma, max;
                               # the two converts of bf16
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


def time_ms(torch, fn, flush, reps=30):
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


def bound(B, HW, C, esize):
    """The least time for one call: x read once and y written once (in
    x's dtype), scale and bias read, mean and rstd written (f32), over
    the memory rate; or the operations over the f32 rate, if larger."""
    nbytes = 2 * B * HW * C * esize + 2 * C * 4 + 2 * B * C * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_ELEMENT * B * HW * C / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def kernel_phase(torch, gn):
    """Kernel against plain at every ResNet-50 GroupNorm shape, at the
    served batch and at batch 32; times at batch 32 in both dtypes."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
              for name in max_err}
    for HW, C, model_relu, count in RESNET50_GN:
        for batch in (SERVE_BATCH, BATCH):
            x = torch.randn(batch, HW, C, generator=gen, device=dev)
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                name = str(dtype).replace("torch.", "")
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
        # x, scale and bias are the batch-32 tensors here.
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            name = str(dtype).replace("torch.", "")
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

            row = {"HW": HW, "C": C, "dtype": name, "relu": relu,
                   "per_forward": count,
                   "ms": time_ms(torch, kernel, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, library, flush)}
            row.update(bound(BATCH, HW, C, xd.element_size()))
            rows.append(row)
            for key in totals[name]:
                totals[name][key] += count * row[key]
            print("time B=%d HW=%d C=%d %s relu=%s x%d: kernel %.4f ms, "
                  "plain %.4f ms, F.group_norm %.4f ms, bound %.4f ms (%s)"
                  % (BATCH, HW, C, name, relu, count, row["ms"],
                     row["plain_ms"], row["library_ms"], row["bound_ms"],
                     row["bound_by"]))
    for tot in totals.values():
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")

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


def forward_phase(torch, gn, module, reps=20):
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

    rows, max_err, totals = kernel_phase(torch, gn)
    for name, tot in totals.items():
        print("kernel per ResNet-50 forward at batch %d (53 calls, %s): "
              "kernel %.4f ms, plain %.4f ms, F.group_norm %.4f ms, bound "
              "%.4f ms (%s)" % (BATCH, name, tot["ms"], tot["plain_ms"],
                                tot["library_ms"], tot["bound_ms"],
                                tot["bound_by"]))

    module, launches, latencies, serve_err = serving_phase(torch, gn)
    forward = forward_phase(torch, gn, module)

    f32 = totals["float32"]
    kernels = [{
        "name": "group_norm_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/group_norm.cu",
        "replaces": "elasticdl_tpu/ops/group_norm.py:98",
        "launches": launches,
        "max_abs_err": max_err["float32"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "times_are": "sum of the 53 calls of one ResNet-50 forward, "
                     "batch %d, float32" % BATCH,
    }]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device": kind,
                       "torch": torch.__version__,
                       "build_s": build_s, "shapes": rows,
                       "per_forward": totals, "max_abs_err": max_err,
                       "serve_latency_ms": latencies,
                       "serve_max_abs_err": serve_err,
                       "forward_ms": forward, "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
