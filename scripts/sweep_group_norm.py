#!/usr/bin/env python3
"""Time variants of the GroupNorm kernels (B1 forward, B2 backward) side
by side on one card, summed over ResNet-50's 53 GroupNorm calls.  Needs
one NVIDIA card.  Run from the root of a checkout:

    python3 scripts/sweep_group_norm.py [--rounds 2] [--parent DIR]

Settings: batch 32 in float32 and bfloat16, batch 128 in bfloat16
(bench.py's training step) and the served batch 4 in float32; the
forward with ReLU as the model uses it, and its backward.  Variants:

 - ``plan``: the committed kernels under ``gn.plan`` as it is;
 - ``streamed``: nothing resident in shared memory, so both passes read
   x (and dy) from device memory (what holding the row on chip buys);
 - ``scalar``: one channel per access and nothing resident, the path
   an unaligned tensor takes (what 16-byte vectors buy over
   ``streamed``);
 - ``cluster8``, ``cluster4``: clusters of at most 8 or 4 blocks (rows
   that no longer fit are read twice);
 - ``half_smem``: at most 116 KB per block, so two blocks share an SM;
 - ``target256``, ``target512``: the plan aiming at 256 or 512 blocks
   (the committed plan aims at 128);
 - ``one_piece``: the resident rows copied in one piece, so the first
   pass starts when the whole copy has landed, and ``pieces8``: in 8
   pieces whatever their size (the plan takes pieces of about 32 KB);
 - ``parent`` (with ``--parent DIR``, the root of a checkout of the
   previous design): its ``group_norm.cu`` and ``group_norm_bwd.cu``,
   built here with ``ops/build.py``'s flags and called through their own
   C interface, for an A/B per shape in the same call;
 - ``threads512``: blocks of 512 threads, checked;
 - ablations, unchecked (wrong by construction): ``empty``, both
   kernels returning as they start (the launch and the affine sum's
   kernel: the fixed cost of a call), and ``no_store``, both storing
   nothing in their second pass (x and dy read, the statistics
   exchanged, nothing written but mean, rstd and the backward's sums);
 - ``yardstick``, unchecked: one ``Tensor.copy_`` of x into y (the
   forward's bytes) and one ``torch.add(x, dy, out=dx)`` (the
   backward's bytes): what one pass of PyTorch's elementwise kernels
   reaches on the same bytes.

Every variant but the ablations and the yardstick is first held against
the plain versions (``chip_smoke.py``'s tolerances; the backward bitwise across
two runs), then timed per call by CUDA events after an L2 flush (as
``chip_smoke.py`` times), in ``--rounds`` rounds that alternate the
variants' order.  Prints the card's name and power limit, the ptxas
lines of the committed kernels, the plan and the number of clusters the
card holds at once for each shape, a table of sums and shares of the
bound, and one JSON object per variant as its last lines.
"""

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import group_norm as gn  # noqa: E402

SETTINGS = [(32, "float32"), (32, "bfloat16"), (128, "bfloat16"),
            (4, "float32")]
KNOBS = {
    "plan": {},
    "streamed": {"smem_budget": 0},
    "scalar": {"aligned": False},
    "cluster8": {"max_cluster": 8},
    "cluster4": {"max_cluster": 4},
    "half_smem": {"smem_budget": 116 * 1024},
    "target256": {"target_blocks": 256},
    "target512": {"target_blocks": 512},
    "one_piece": {"piece_bytes": 1 << 30},
    "pieces8": {"piece_bytes": 1},
}
PARENT_ELEMS_PER_CHUNK = 8192   # the previous design's chunk of rows
# Rebuilt variants: (threads per block, checked, textual edits (file,
# pattern, replacement), each pattern replaced wherever it occurs, and
# occurring; file None edits both kernel sources).
_START = "  gn::cluster_arrive_relaxed();\n"
REBUILT = {
    "threads512": (512, True, [
        ("gn_common.cuh", "constexpr int kThreads = 256;",
         "constexpr int kThreads = 512;")]),
    "empty": (256, False, [(None, _START, "  if (C > 0) return;\n" + _START)]),
    "no_store": (256, False, [
        (None, "gn::store_global<T, V>(",
         "if (C < 0) gn::store_global<T, V>(")]),
}


def planned(**knobs):
    """``gn.plan`` with ``knobs`` overriding the caller's arguments."""
    plan = gn.plan

    def wrapped(*args, **kwargs):
        kwargs.update(knobs)
        return plan(*args, **kwargs)
    return wrapped


def build_parent(parent, out_dir):
    """The previous design's two libraries, bound to its C interface."""
    csrc = os.path.join(parent, "elasticdl_tpu_torch", "ops", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("group_norm", "group_norm_bwd"):
        lib = os.path.join(out_dir, "libparent_%s.so" % name)
        cmd = [build.nvcc_path()] + build.NVCC_FLAGS + [
            "-I", csrc, "-o", lib, os.path.join(csrc, name + ".cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit("nvcc failed for the parent's %s:\n%s"
                             % (name, text))
        libs[name] = ctypes.CDLL(lib)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = libs["group_norm"], libs["group_norm_bwd"]
    fwd.edl_group_norm_fwd.argtypes = [ptr] * 7 + [cint] * 5 + [
        ctypes.c_float, cint, cint, ptr]
    fwd.edl_group_norm_fwd_workspace.argtypes = [cint] * 4
    fwd.edl_group_norm_fwd_workspace.restype = ctypes.c_int64
    bwd.edl_group_norm_bwd.argtypes = [ptr] * 10 + [cint] * 7 + [ptr]
    bwd.edl_group_norm_bwd_workspace.argtypes = [cint] * 5
    bwd.edl_group_norm_bwd_workspace.restype = ctypes.c_int64

    def rows(HW, C):
        return max(1, min(HW, PARENT_ELEMS_PER_CHUNK // C))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def group_norm_fwd(x3, scale, bias, G, eps=1e-6, relu=False):
        B, HW, C = x3.shape
        r = rows(HW, C)
        y = torch.empty_like(x3)
        mean = torch.empty((B, 1, C), dtype=torch.float32, device=x3.device)
        rstd = torch.empty_like(mean)
        work = torch.empty(fwd.edl_group_norm_fwd_workspace(B, HW, C, r),
                           dtype=torch.float32, device=x3.device)
        err = fwd.edl_group_norm_fwd(
            x3.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), work.data_ptr(), B, HW, C, G,
            r, eps, int(relu), gn._DTYPES[x3.dtype], stream())
        if err:
            raise RuntimeError("parent forward: cudaError_t %d" % err)
        return y, mean, rstd

    def group_norm_bwd(x3, dy3, scale, bias, mean, rstd, G, eps=1e-6,
                       relu=False):
        B, HW, C = x3.shape
        r = rows(HW, C)
        dx = torch.empty_like(x3)
        dscale = torch.empty(C, dtype=torch.float32, device=x3.device)
        dbias = torch.empty_like(dscale)
        work = torch.empty(bwd.edl_group_norm_bwd_workspace(B, HW, C, G, r),
                           dtype=torch.float32, device=x3.device)
        err = bwd.edl_group_norm_bwd(
            x3.data_ptr(), dy3.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), work.data_ptr(), B, HW, C,
            G, r, int(relu), gn._DTYPES[x3.dtype], stream())
        if err:
            raise RuntimeError("parent backward: cudaError_t %d" % err)
        return dx, dscale, dbias

    return group_norm_fwd, group_norm_bwd


def build_rebuilt(out_dir):
    """{variant: (forward library, backward library)}, each built
    concurrently from a copy of ``csrc/`` with REBUILT's edits."""
    procs = []
    for variant, (_, _, edits) in REBUILT.items():
        vdir = os.path.join(out_dir, variant)
        os.makedirs(vdir, exist_ok=True)
        texts = {}
        for name in os.listdir(build.CSRC):
            with open(os.path.join(build.CSRC, name)) as f:
                texts[name] = f.read()
        for target, old, new in edits:
            for name in ([target] if target else
                         ["group_norm.cu", "group_norm_bwd.cu"]):
                if old not in texts[name]:
                    raise SystemExit("%r is not in %s" % (old, name))
                texts[name] = texts[name].replace(old, new)
        for name, text in texts.items():
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        for name in ("group_norm", "group_norm_bwd"):
            lib = os.path.join(vdir, "lib%s.so" % name)
            cmd = [build.nvcc_path()] + build.NVCC_FLAGS + [
                "-o", lib, os.path.join(vdir, name + ".cu")]
            procs.append((variant, name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for variant, name, lib, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit("nvcc failed for %s %s:\n%s" % (variant, name,
                                                             text))
        for line in ptxas_lines({name: text}):
            print("nvcc %s %s" % (variant, line))
        bind = gn.bind_fwd if name == "group_norm" else gn.bind_bwd
        libs.setdefault(variant, []).append(bind(ctypes.CDLL(lib)))
    return {variant: tuple(pair) for variant, pair in libs.items()}


def ptxas_lines(outputs):
    return ["%s: %s" % (name, line.replace("ptxas info    : ", "").strip())
            for name, text in outputs.items() if name.startswith("group")
            for line in text.splitlines()
            if any(k in line for k in ("entry function", "registers",
                                       "spill"))]


def report_plans(batch, name):
    fwd_lib, bwd_lib = gn._library(), gn._bwd_library()
    esize = 4 if name == "float32" else 2
    for HW, C, _, _ in chip_smoke.RESNET50_GN:
        for backward, fn in ((False, fwd_lib.edl_group_norm_fwd_max_clusters),
                             (True, bwd_lib.edl_group_norm_bwd_max_clusters)):
            p = gn.plan(batch, HW, C, chip_smoke.GROUPS, esize, backward)
            print("plan B=%d %dx%d %s %s: cluster %d, rows %d, resident %d,"
                  " %d shared bytes; %d clusters at once" % (
                      batch, HW, C, name, "bwd" if backward else "fwd",
                      p.cluster, p.rows, p.resident, p.smem,
                      fn(p.cluster, p.smem, gn._DTYPES[getattr(torch, name)],
                         p.vec)))


def make_cases(gen, dev):
    """{(batch, dtype, direction): [(HW, C, count, args, bound_ms)]}."""
    cases = {}
    for batch, name in SETTINGS:
        dtype = getattr(torch, name)
        for HW, C, relu, count in chip_smoke.RESNET50_GN:
            x = torch.randn(batch, HW, C, generator=gen, device=dev).to(dtype)
            dy = torch.randn(batch, HW, C, generator=gen, device=dev).to(
                dtype)
            scale = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            _, mean, rstd = gn._fwd_ref(x, scale, bias, chip_smoke.GROUPS,
                                        1e-6, relu)
            G = chip_smoke.GROUPS
            esize = x.element_size()
            cases.setdefault((batch, name, "fwd"), []).append(
                (HW, C, count, (x, scale, bias, G, 1e-6, relu),
                 chip_smoke.bound(batch, HW, C, esize)["bound_ms"]))
            cases.setdefault((batch, name, "bwd"), []).append(
                (HW, C, count, (x, dy, scale, bias, mean, rstd, G, 1e-6,
                                relu),
                 chip_smoke.bound(batch, HW, C, esize,
                                  backward=True)["bound_ms"]))
    return cases


def check(direction, fns, args, what):
    """The variant against the plain version, as chip_smoke.py gates."""
    if direction == "fwd":
        got = fns[0](*args)
        ref = gn._fwd_ref(*args)
        name = str(args[0].dtype).replace("torch.", "")
        atol, rtol = chip_smoke.TOL[name]
        chip_smoke.check_close(what, got[0], ref[0], atol, rtol)
        chip_smoke.check_close(what + " mean", got[1], ref[1], 2e-5, 2e-5)
        chip_smoke.check_close(what + " rstd", got[2], ref[2], 2e-5, 2e-5)
        return
    got, again = fns[1](*args), fns[1](*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        chip_smoke.fail("%s: two runs are not bitwise equal" % what)
    ref = gn._bwd_ref(*args)
    name = str(args[0].dtype).replace("torch.", "")
    atol, rtol = chip_smoke.BWD_TOL[name]
    chip_smoke.check_close(what + " dx", got[0], ref[0], atol, rtol)
    for g, r in zip(got[1:], ref[1:]):
        chip_smoke.check_close(what + " dscale/dbias", g, r,
                               1e-4 * float(r.abs().max()), 0.0)


def yardstick(direction, args):
    x = args[0]
    if direction == "fwd":
        y = torch.empty_like(x)
        return lambda: y.copy_(x)
    dx = torch.empty_like(x)
    return lambda: torch.add(x, args[1], out=dx)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--parent", default="",
                        help="root of a checkout of the previous design")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    print(chip_smoke.nvidia_smi_line())
    for line in ptxas_lines(build.build_all()):
        print("nvcc %s" % line)
    # name: (plan, (forward, backward) functions, (forward, backward)
    # libraries, threads, checked); None keeps the committed one.
    variants = {name: (planned(**knobs), None, None, gn.THREADS, True)
                for name, knobs in KNOBS.items()}
    if args.parent:
        variants["parent"] = (None, build_parent(
            os.path.abspath(args.parent),
            os.path.join(build.BUILD_DIR, "sweep")), None, gn.THREADS, True)
    for name, libs in build_rebuilt(
            os.path.join(build.BUILD_DIR, "sweep")).items():
        threads, checked, _ = REBUILT[name]
        variants[name] = (None, None, libs, threads, checked)
    variants["yardstick"] = (None, None, None, gn.THREADS, False)
    for batch, name in SETTINGS:
        report_plans(batch, name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = make_cases(gen, dev)
    names = list(variants)
    times = {v: {key: [[] for _ in shapes] for key, shapes in cases.items()}
             for v in names}
    committed = (gn.plan, gn._library, gn._bwd_library, gn.THREADS)
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    try:
        for rnd in range(args.rounds):
            for v in (names if rnd % 2 == 0 else names[::-1]):
                plan, fns, libs, gn.THREADS, checked = variants[v]
                committed[0].cache_clear()   # its plans depend on THREADS
                gn.plan = plan or committed[0]
                gn._library, gn._bwd_library = (
                    (lambda lib=libs[0]: lib, lambda lib=libs[1]: lib)
                    if libs else committed[1:3])
                fns = fns or kernels
                for key, shapes in cases.items():
                    batch, name, direction = key
                    for i, (HW, C, _, call_args, _) in enumerate(shapes):
                        if v == "yardstick":
                            fn = yardstick(direction, call_args)
                        else:
                            if rnd == 0 and checked:
                                check(direction, fns, call_args,
                                      "%s %s B=%d %dx%d %s" % (
                                          v, direction, batch, HW, C, name))
                            fn = functools.partial(
                                fns[direction == "bwd"], *call_args)
                        times[v][key][i].append(
                            chip_smoke.time_ms(torch, fn, flush))
    finally:
        gn.plan, gn._library, gn._bwd_library, gn.THREADS = committed
        gn.plan.cache_clear()
    results = {}
    for v in names:
        per = {}
        for key, shapes in cases.items():
            ms = [float(np.median(t)) for t in times[v][key]]
            total = sum(c * m for (_, _, c, _, _), m in zip(shapes, ms))
            bound_ms = sum(c * b for (_, _, c, _, b) in shapes)
            per["B=%d %s %s" % key] = {
                "ms": total, "bound_ms": bound_ms,
                "share_of_bound": bound_ms / total,
                "per_shape_ms": {"%dx%d" % (HW, C): m for (HW, C, _, _, _), m
                                 in zip(shapes, ms)}}
        results[v] = per
    keys = list(results["plan"])
    print("%-10s " % "variant" + " ".join("%22s" % k for k in keys))
    for v, per in results.items():
        print("%-10s " % v + " ".join(
            "%11.4f ms %5.1f %%" % (per[k]["ms"],
                                    100 * per[k]["share_of_bound"])
            for k in keys))
    for v, per in results.items():
        print(json.dumps({"variant": v, "checked": variants[v][4],
                          "sums": per}))


if __name__ == "__main__":
    main()
