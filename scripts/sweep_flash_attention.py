#!/usr/bin/env python3
"""Time variants of the flash attention kernels side by side on one card:
the forward (B3, ``--kernel fwd``, the default) or the backward pair (B4
dq and B5 dk/dv, ``--kernel bwd``).  Needs one NVIDIA card.  Run from the
root of a checkout:

    python3 scripts/sweep_flash_attention.py [--kernel fwd|bwd] [--rounds 2]
    python3 scripts/sweep_flash_attention.py --ablate
    python3 scripts/sweep_flash_attention.py --kernel bwd --ablate

Each variant is the committed source (``elasticdl_tpu_torch/ops/csrc/
flash_attention.cu`` or ``flash_attention_bwd.cu``) with one design choice
changed by textual substitutions (every occurrence of a pattern that must
occur).  Forward (B3; bf16 D=64 is the wgmma kernel, the flagship LM's
path):

 - ``committed``: the source as it is (128-row blocks of two consumer
   warpgroups and a producer warp, two blocks per SM, a ring of 4
   stages, blocks launched in groups of 16 heads, each warpgroup's S ->
   softmax -> P V chain serial);
 - ``mma_sync``: bf16 D=64 dispatched to the earlier mma.sync kernel
   (``flash_fwd_bf16<64, 4>``, 64-row blocks, four blocks per SM), the
   design this one replaced, timed in the same call;
 - ``stages_2``, ``stages_3``, ``stages_6``: a ring of 2, 3 or 6 stages;
 - ``group_8``, ``group_32``: groups of 8 or 32 heads;
 - ``pingpong``: the warpgroups issue their products in turns (named
   barriers), so one's softmax runs under the other's wgmma;
 - ``overlap``: each warpgroup issues tile j's S before tile j - 1's
   P V and runs tile j's softmax under that product;
 - ``pingpong_overlap``: both (the scheduling of FlashAttention-3);
 - ``one_block``: the registers of one block per SM (ptxas then takes
   103), and ``overlap_one_block``, the overlap with room for it;
 - ``consumers_3``, ``consumers_4``: one block per SM of 192 or 256 rows,
   3 or 4 consumer warpgroups (fewer K/V rereads from L2).

Backward (bf16, D=64, the path the flagship LM trains on):

 - ``committed``: the source as it is (the wgmma kernels, a ring of 4
   stages, blocks launched in groups of 16 heads);
 - ``stages_2``, ``stages_3``: a ring of 2 or 3 stages of streamed tiles;
 - ``group_8``, ``group_32``: groups of 8 or 32 heads;
 - ``heads_fastest``: one group of every head, i.e. each rank across all
   heads before the next rank (the order of the mma.sync kernels).

``--ablate`` times the committed wgmma kernels (forward, or backward)
beside variants that each remove one part of the work, to see what
bounds them; their outputs are wrong by construction, so they are timed
and not checked:

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
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from elasticdl_tpu_torch.ops import build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

_FWD_STAGES = "constexpr int kFwdStages = 4;"
_FWD_GROUP = "constexpr int kFwdHeadGroup = 16;"
_ONE_BLOCK = ("__launch_bounds__(kFwdThreads, 2)",
              "__launch_bounds__(kFwdThreads, 1)")
_PINGPONG = ("constexpr bool kPingPong = false;",
             "constexpr bool kPingPong = true;")
_OVERLAP = ("constexpr bool kOverlap = false;",
            "constexpr bool kOverlap = true;")


def _consumers(n):     # one block of n consumer warpgroups per SM
    return [("constexpr int kConsumers = 2;",
             "constexpr int kConsumers = %d;" % n), _ONE_BLOCK]


FWD_VARIANTS = {
    "committed": [],
    "mma_sync": [("if (D == 64) return launch_wgmma(prm, B, stream);",
                  "if (D == 64)\n      return launch(flash_fwd_bf16<64, 4>, "
                  "Bf16Smem<64>::bytes, prm, grid, stream);")],
    "stages_2": [(_FWD_STAGES, _FWD_STAGES.replace("4", "2"))],
    "stages_3": [(_FWD_STAGES, _FWD_STAGES.replace("4", "3"))],
    "stages_6": [(_FWD_STAGES, _FWD_STAGES.replace("4", "6"))],
    "group_8": [(_FWD_GROUP, _FWD_GROUP.replace("16", "8"))],
    "group_32": [(_FWD_GROUP, _FWD_GROUP.replace("16", "32"))],
    "pingpong": [_PINGPONG],
    "overlap": [_OVERLAP],
    "pingpong_overlap": [_PINGPONG, _OVERLAP],
    "one_block": [_ONE_BLOCK],
    "overlap_one_block": [_OVERLAP, _ONE_BLOCK],
    "consumers_3": _consumers(3),
    "consumers_4": _consumers(4),
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
_NO_EXP2 = [("ex2(", "ex2_ablated("), (_INCLUDE, _INCLUDE + (
    "namespace { __device__ __forceinline__ float ex2_ablated(float x) "
    "{ return x; } }\n"))]
_NO_MMA = [("wgmma_ss(", "ablated_mma("), ("wgmma_rs_mn(", "ablated_mma("),
           (_INCLUDE, _INCLUDE + _ABLATED_MMA)]
FWD_ABLATIONS = {     # the forward's live-tile test is B4's, word for word
    "committed": [],
    "no_exp2": _NO_EXP2,
    "one_warpgroup": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (wg == 0 && "))],
    "no_mma": _NO_MMA,
    "no_consume": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (false && "))],
}
BWD_ABLATIONS = {
    "committed": [],
    "no_exp2": _NO_EXP2,
    "one_warpgroup": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (wg == 0 && ")),
                      (_B5_LIVE, _B5_LIVE.replace("if (", "if (wg == 0 && "))],
    "no_mma": _NO_MMA,
    "no_consume": [(_B4_LIVE, _B4_LIVE.replace("if (", "if (false && ")),
                   (_B5_LIVE, _B5_LIVE.replace("if (", "if (false && "))],
}
# (B, H, T, D, dtype, causal, window): the flagship long prefill in both
# dtypes, head_dim 128 at the same FLOPs, the served prompt, and the
# other masks at a cut batch.  --ablate times the bf16 D=64 ones.
FWD_SHAPES = [(8, 16, 2048, 64, "bfloat16", True, 0),
              (8, 16, 2048, 64, "float32", True, 0),
              (8, 8, 2048, 128, "bfloat16", True, 0),
              (8, 16, 128, 64, "bfloat16", True, 0),
              (2, 16, 2048, 64, "bfloat16", False, 0),
              (2, 16, 2048, 64, "bfloat16", True, 256)]
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
        built[variant] = (lib, [_ptxas_line(line) for line in text.splitlines()
                                if any(key in line for key in (
                                    "entry function", "registers", "spill",
                                    "C75"))])
    return built


def _ptxas_line(line):
    """A ptxas line with each mangled kernel name cut to the kernel's
    own (``flash_fwd_wgmma``, ``flash_fwd_bf16<128, 1>``, ...)."""
    def short(match):
        name = re.search(r"(flash_fwd_[a-z0-9]+|bwd_[a-z]+_[a-z0-9]+)"
                         r"(?:ILi(\d+)ELi(\d+)E)?", match.group(0))
        if name is None:
            return match.group(0)
        args = [a for a in name.groups()[1:] if a]
        return name.group(1) + ("<%s>" % ", ".join(args) if args else "")
    return re.sub(r"_Z\w+", short, line.replace("ptxas info    : ", "")
                  .strip())


def fwd_cases(gen, dev, ablate=False):
    cases = []
    for B, H, T, D, name, causal, window in FWD_SHAPES:
        if ablate and (D, name) != (64, "bfloat16"):
            continue
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        ref = fa._flash_ref(q, k, v, causal, D ** -0.5, window)
        label = "%dx%dx%dx%d %s causal=%s window=%d" % (B, H, T, D, name,
                                                        causal, window)
        cases.append((label, (q, k, v, causal, window, name, ref)))
    return cases


def fwd_check_and_time(variant, label, case, flush, check=True):
    """The kernel against ``_flash_ref`` under chip_smoke.py's gate (out,
    l and m; unless ``check`` is false: the ablations), then its time."""
    q, k, v, causal, window, name, ref = case
    call = functools.partial(fa.flash_forward, q, k, v, causal=causal,
                             window=window)
    if check:
        got = call()
        torch.cuda.synchronize()
        atol, rtol = chip_smoke.FLASH_TOL[name]
        what = "%s %s" % (variant, label)
        chip_smoke.check_close(what, got[0], ref[0], atol, rtol)
        s_max = float((torch.matmul(q.float(), k.float().transpose(-1, -2))
                       * q.shape[-1] ** -0.5).abs().max())
        chip_smoke.check_close(what + " m", got[2], ref[2], 1e-5 * s_max,
                               0.0)
        chip_smoke.check_close(what + " l", got[1], ref[1], 0.0, 2e-5)
    return {"ms": chip_smoke.time_ms(torch, call, flush)}


def bwd_cases(gen, dev, ablate=False):
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
            "_library", fa._bind, FWD_ABLATIONS),
    "bwd": ("flash_attention_bwd", BWD_VARIANTS, bwd_cases,
            bwd_check_and_time, "_bwd_library", fa._bind_bwd, BWD_ABLATIONS),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=sorted(MODES), default="fwd")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--ablate", action="store_true",
                        help="time the ablations (unchecked)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    (source, variants, make_cases, check_and_time, attr, bind,
     ablations) = MODES[args.kernel]
    if args.ablate:
        variants = ablations
        check_and_time = functools.partial(check_and_time, check=False)
    print(chip_smoke.nvidia_smi_line())
    built = build_variants(source, variants,
                           os.path.join(build.BUILD_DIR, "sweep"))
    libs = {name: bind(ctypes.CDLL(path)) for name, (path, _) in built.items()}
    for name, (_, regs) in built.items():
        print("%s: %s" % (name, regs))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = make_cases(gen, dev, args.ablate)
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
