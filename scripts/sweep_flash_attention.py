#!/usr/bin/env python3
"""Time variants of the flash attention forward kernel (B3) side by side
on one card.  Needs one NVIDIA card.  Run from the root of a checkout:

    python3 scripts/sweep_flash_attention.py [--rounds 2]

Each variant is the committed source,
``elasticdl_tpu_torch/ops/csrc/flash_attention.cu``, with one design
choice changed by textual substitutions (every occurrence of a pattern
that must occur):

 - ``committed``: the source as it is;
 - ``min_blocks_1``: no register cap for D=64 (the compiler's choice,
   fewer blocks per SM);
 - ``q_tiles_fastest``: the grid's fastest axis runs the q tiles of one
   head instead of the heads.

All variants are built with ``ops/build.py``'s flags, one ``nvcc`` each,
all started together, into the git-ignored ``ops/_build/sweep/``.  Each
is first held against the plain version ``_flash_ref`` (the tolerances
of ``chip_smoke.py``), then timed per call by CUDA events after an L2
flush, in ``--rounds`` rounds that alternate the variants' order.
Prints the card's name and power limit, each variant's registers, and
one JSON object per variant as its last lines.
"""

import argparse
import ctypes
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

VARIANTS = {
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
# (B, H, T, D, dtype): the flagship long prefill in both dtypes, head_dim
# 128, and the served prompt.
SHAPES = [(8, 16, 2048, 64, "bfloat16"), (8, 16, 2048, 64, "float32"),
          (4, 8, 2048, 128, "bfloat16"), (8, 16, 128, 64, "bfloat16")]


def variant_source(source, substitutions):
    for old, new in substitutions:
        if old not in source:
            raise SystemExit("pattern not in the source: %r" % old)
        source = source.replace(old, new)
    return source


def build_variants(out_dir):
    """{name: (library path, registers line)}, built concurrently."""
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        source = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = os.path.join(out_dir, name + ".cu")
        with open(src, "w") as f:
            f.write(variant_source(source, subs))
        lib = os.path.join(out_dir, "lib%s.so" % name)
        cmd = [build.nvcc_path()] + build.NVCC_FLAGS + ["-I", build.CSRC,
                                                        "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit("nvcc failed for %s:\n%s" % (name, text))
        built[name] = (lib, [line.strip() for line in text.splitlines()
                             if "registers" in line])
    return built


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    print(chip_smoke.nvidia_smi_line())
    built = build_variants(os.path.join(build.BUILD_DIR, "sweep"))
    libs = {name: fa._bind(ctypes.CDLL(path))
            for name, (path, _) in built.items()}
    for name, (_, regs) in built.items():
        print("%s: %s" % (name, regs))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = []
    for B, H, T, D, name in SHAPES:
        q, k, v = (torch.randn(B, H, T, D, generator=gen, device=dev).to(
            getattr(torch, name)) for _ in range(3))
        cases.append((q, k, v, fa._flash_ref(q, k, v, True, D ** -0.5)))
    library = fa._library
    times = {name: [[] for _ in SHAPES] for name in libs}
    try:
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                fa._library = lambda lib=libs[name]: lib
                for i, (shape, (q, k, v, ref)) in enumerate(
                        zip(SHAPES, cases)):
                    got = fa.flash_forward(q, k, v)
                    torch.cuda.synchronize()
                    atol, rtol = chip_smoke.FLASH_TOL[shape[-1]]
                    chip_smoke.check_close("%s %s" % (name, shape), got[0],
                                           ref[0], atol, rtol)
                    chip_smoke.check_close("%s %s l" % (name, shape),
                                           got[1], ref[1], 0.0, 2e-5)
                    times[name][i].append(chip_smoke.time_ms(
                        torch, lambda: fa.flash_forward(q, k, v), flush))
    finally:
        fa._library = library
    for name, per_shape in times.items():
        print(json.dumps({
            "variant": name, "registers": built[name][1],
            "ms": {"%dx%dx%dx%d %s" % shape: float(np.median(t))
                   for shape, t in zip(SHAPES, per_shape)},
            "runs_ms": per_shape}))


if __name__ == "__main__":
    main()
