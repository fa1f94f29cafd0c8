#!/usr/bin/env python3
"""Time variants of the flash attention kernels side by side on one card:
the forward (B3, ``--kernel fwd``, the default) or the backward pair (B4
dq and B5 dk/dv, ``--kernel bwd``).  Needs one NVIDIA card.  Run from the
root of a checkout:

    python3 scripts/sweep_flash_attention.py [--kernel fwd|bwd] [--rounds 2]
    python3 scripts/sweep_flash_attention.py --kernel bwd --ablate

Each variant is the committed source (``elasticdl_tpu_torch/ops/csrc/
flash_attention.cu`` or ``flash_attention_bwd.cu``) with one design choice
changed by textual substitutions (every occurrence of a pattern that must
occur).  Forward:

 - ``committed``: the source as it is;
 - ``min_blocks_1``: no register cap for D=64 (the compiler's choice,
   fewer blocks per SM);
 - ``q_tiles_fastest``: the grid's fastest axis runs the q tiles of one
   head instead of the heads.

Backward (bf16, D=64, the path the flagship LM trains on):

 - ``committed``: the source as it is (the wgmma kernels, a ring of 4
   stages, blocks launched in groups of 16 heads);
 - ``stages_2``, ``stages_3``: a ring of 2 or 3 stages of streamed tiles;
 - ``group_8``, ``group_32``: groups of 8 or 32 heads;
 - ``heads_fastest``: one group of every head, i.e. each rank across all
   heads before the next rank (the order of the mma.sync kernels).

``--ablate`` (backward only) times the committed kernels beside variants
that each remove one part of the work, to see what bounds them; their
outputs are wrong by construction, so they are timed and not checked:

 - ``no_exp2``: the exp2 of p replaced by the identity;
 - ``one_warpgroup``: only consumer warpgroup 0 computes (half the rows);
 - ``no_mma``: every wgmma replaced by nothing (the elementwise work and
   the loads remain);
 - ``no_consume``: the consumers compute nothing (the loads, the
   barriers and the ring remain).

All variants are built with ``ops/build.py``'s flags, one ``nvcc`` each,
all started together, into the git-ignored ``ops/_build/sweep/``.  Each
is first held against the plain version (``_flash_ref``, or
``_flash_bwd_ref`` with ``chip_smoke.py``'s backward gate), then timed
per call by CUDA events after an L2 flush, in ``--rounds`` rounds that
alternate the variants' order.  Prints the card's name and power limit,
each variant's registers, and one JSON object per variant as its last
lines.
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
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

FWD_VARIANTS = {
    "committed": [],
    "min_blocks_1": [("flash_fwd_bf16<64, 4>", "flash_fwd_bf16<64, 1>")],
    "q_tiles_fastest": [
        ("  const int bh = blockIdx.x;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;\n",
         "  const int bh = blockIdx.y;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;\n"),
        ("const dim3 grid(B * H, (T + kBQ - 1) / kBQ);",
         "const dim3 grid((T + kBQ - 1) / kBQ, B * H);"),
    ],
}
_STAGES = "constexpr int kHopStages = 4;"
_GROUP = "constexpr int kHeadGroup = 16;"
BWD_VARIANTS = {
    "committed": [],
    "stages_2": [(_STAGES, _STAGES.replace("4", "2"))],
    "stages_3": [(_STAGES, _STAGES.replace("4", "3"))],
    "group_8": [(_GROUP, _GROUP.replace("16", "8"))],
    "group_32": [(_GROUP, _GROUP.replace("16", "32"))],
    "heads_fastest": [(_GROUP, _GROUP.replace("16", "(1 << 16)"))],
}
_INCLUDE = '#include "hopper.cuh"\n'
_B4_LIVE = "if (tile_live(prm, qw0, k_begin + j * kStream))"
_B5_LIVE = "if (tile_live(prm, q_begin + j * kStream, kw0))"
# Stand-ins for the two wgmma wrappers that keep every operand alive, so
# the work that feeds them is not optimised away.
_ABLATED_MMA = r"""namespace {
__device__ __forceinline__ void ablated_mma(float (&d)[32], uint64_t a,
                                            uint64_t b, int c) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("" : "+f"(d[i]) : "l"(a), "l"(b), "r"(c));
}
__device__ __forceinline__ void ablated_mma(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("" : "+f"(d[i])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
}
"""
BWD_ABLATIONS = {
    "committed": [],
    "no_exp2": [("ex2(", "ex2_ablated("), (_INCLUDE, _INCLUDE + (
        "namespace { __device__ __forceinline__ float ex2_ablated(float x) "
        "{ return x; } }\n"))],
    "one_warpgroup": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (wg == 0 && ")),
                      (_B5_LIVE, _B5_LIVE.replace("if (", "if (wg == 0 && "))],
    "no_mma": [("wgmma_ss(", "ablated_mma("), ("wgmma_rs_mn(", "ablated_mma("),
               (_INCLUDE, _INCLUDE + _ABLATED_MMA)],
    "no_consume": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (false && ")),
                   (_B5_LIVE, _B5_LIVE.replace("if (", "if (false && "))],
}
# (B, H, T, D, dtype): the flagship long prefill in both dtypes, head_dim
# 128, and the served prompt; all causal.
FWD_SHAPES = [(8, 16, 2048, 64, "bfloat16"), (8, 16, 2048, 64, "float32"),
              (4, 8, 2048, 128, "bfloat16"), (8, 16, 128, 64, "bfloat16")]
# (B, H, T, D, causal, window), bf16: the flagship training shape, and
# the backward's other masks at a cut batch.
BWD_SHAPES = [(8, 16, 2048, 64, True, 0), (2, 16, 2048, 64, False, 0),
              (2, 16, 2048, 64, True, 256)]


def variant_source(source, substitutions):
    for old, new in substitutions:
        if old not in source:
            raise SystemExit("pattern not in the source: %r" % old)
        source = source.replace(old, new)
    return source


def build_variants(name, variants, out_dir):
    """{variant: (library path, registers lines)}, built concurrently."""
    with open(os.path.join(build.CSRC, name + ".cu")) as f:
        source = f.read()
    os.makedirs(out_dir, exist_ok=True)
    texts = {variant: variant_source(source, subs)  # all before any nvcc
             for variant, subs in variants.items()}
    procs = {}
    for variant, text in texts.items():
        src = os.path.join(out_dir, "%s_%s.cu" % (name, variant))
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "lib%s_%s.so" % (name, variant))
        cmd = [build.nvcc_path()] + build.NVCC_FLAGS + ["-I", build.CSRC,
                                                        "-o", lib, src]
        procs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for variant, (lib, proc) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (variant, text))
        built[variant] = (lib, [line.strip() for line in text.splitlines()
                                if "registers" in line or "spill" in line or "C75" in line])
    return built


def fwd_cases(gen, dev):
    cases = []
    for B, H, T, D, name in FWD_SHAPES:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        ref = fa._flash_ref(q, k, v, True, D ** -0.5)
        cases.append(("%dx%dx%dx%d %s" % (B, H, T, D, name), (q, k, v, ref)))
    return cases


def fwd_check_and_time(variant, label, case, flush):
    q, k, v, ref = case
    got = fa.flash_forward(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = chip_smoke.FLASH_TOL[label.split()[-1]]
    chip_smoke.check_close("%s %s" % (variant, label), got[0], ref[0], atol,
                           rtol)
    chip_smoke.check_close("%s %s l" % (variant, label), got[1], ref[1],
                           0.0, 2e-5)
    return {"ms": chip_smoke.time_ms(
        torch, lambda: fa.flash_forward(q, k, v), flush)}


def bwd_cases(gen, dev):
    cases = []
    for B, H, T, D, causal, window in BWD_SHAPES:
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(4))
        out, l, m = fa.flash_forward(q, k, v, causal=causal, window=window)
        ref = fa._flash_bwd_ref(q, k, v, out, l, m, g, causal, D ** -0.5,
                                window)
        label = "%dx%dx%dx%d causal=%s window=%d" % (B, H, T, D, causal,
                                                     window)
        cases.append((label, (q, k, v, out, l, m, g, causal, window, ref)))
    return cases


def bwd_check_and_time(variant, label, case, flush, check=True):
    """Both kernels against ``_flash_bwd_ref`` under chip_smoke.py's bf16
    gate (unless ``check`` is false: the ablations), then each one's
    time."""
    q, k, v, out, l, m, g, causal, window, ref = case
    if check:
        got = fa.flash_backward(q, k, v, out, l, m, g, causal=causal,
                                window=window)
        torch.cuda.synchronize()
        row_tol, norm_tol = chip_smoke.FLASH_BWD_TOL["bfloat16"]
        for part, a, r in zip(("dq", "dk", "dv"), got, ref):
            _, row, rel = chip_smoke.bwd_errors(a, r)
            if not (row <= row_tol and rel <= norm_tol):
                raise SystemExit(
                    "%s %s %s: worst row %.3g, norm-relative %.3g"
                    % (variant, label, part, row, rel))
    scale = q.shape[-1] ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = fa._bwd_scratch(q)
    fa._launch_dq(q, k, v, out, l, m, g, dq, delta, causal, scale, window)
    return {
        "dq_ms": chip_smoke.time_ms(torch, lambda: fa._launch_dq(
            q, k, v, out, l, m, g, dq, delta, causal, scale, window), flush),
        "dkv_ms": chip_smoke.time_ms(torch, lambda: fa._launch_dkv(
            q, k, v, out, l, m, g, dk, dv, delta, causal, scale, window),
            flush)}


MODES = {
    "fwd": ("flash_attention", FWD_VARIANTS, fwd_cases, fwd_check_and_time,
            "_library", fa._bind),
    "bwd": ("flash_attention_bwd", BWD_VARIANTS, bwd_cases,
            bwd_check_and_time, "_bwd_library", fa._bind_bwd),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=sorted(MODES), default="fwd")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--ablate", action="store_true",
                        help="backward: time the ablations (unchecked)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    source, variants, make_cases, check_and_time, attr, bind = MODES[
        args.kernel]
    if args.ablate:
        if args.kernel != "bwd":
            raise SystemExit("--ablate is for --kernel bwd")
        variants = BWD_ABLATIONS
        check_and_time = functools.partial(bwd_check_and_time, check=False)
    print(chip_smoke.nvidia_smi_line())
    built = build_variants(source, variants,
                           os.path.join(build.BUILD_DIR, "sweep"))
    libs = {name: bind(ctypes.CDLL(path)) for name, (path, _) in built.items()}
    for name, (_, regs) in built.items():
        print("%s: %s" % (name, regs))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = make_cases(gen, dev)
    loader = getattr(fa, attr)
    times = {name: {label: {} for label, _ in cases} for name in libs}
    try:
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                setattr(fa, attr, lambda lib=libs[name]: lib)
                for label, case in cases:
                    for key, ms in check_and_time(name, label, case,
                                                  flush).items():
                        times[name][label].setdefault(key, []).append(ms)
    finally:
        setattr(fa, attr, loader)
    for name, per_case in times.items():
        print(json.dumps({
            "kernel": args.kernel, "variant": name,
            "checked": not args.ablate,
            "registers": built[name][1],
            "ms": {label: {key: float(np.median(runs))
                           for key, runs in per_key.items()}
                   for label, per_key in per_case.items()},
            "runs_ms": per_case}))


if __name__ == "__main__":
    main()
