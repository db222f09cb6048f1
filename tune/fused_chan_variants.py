#!/usr/bin/env python3
"""Time variants of the fused plan channelizer kernel
(``lora_tpu_torch/csrc/fused_chan.cu``) at both plan shapes, on one GPU.

    python3 tune/fused_chan_variants.py

Each variant is the kernel's source with some of its tuning constants
changed (threads, outputs a thread, channels a block, phases a stage), or
with its text changed: ``cp.async-staging`` stages the input by 4-byte
``cp.async`` copies in place of loads and stores, and
``input-staged-once`` stages the input for the first stage alone (timing
only: its sums are wrong, and it is not checked; its time less the
kernel's is the staging cost that the other blocks of an SM do not hide).
A substitution that no longer finds its text once in the source stops the
script. Every variant is built with the port's ``nvcc`` flags (one
``nvcc`` each, all started together) into a build directory beside this
script, loaded with ctypes, checked against the plain version
(``fused_channelize_planes``) at the EU868 (C = 7, D = 8, 77 taps) and
US915 (C = 23, D = 32, 309 taps) plan shapes of ``bench.py
--plan-gateway`` (n_out = 450,551), and at US915 cut to fill whole waves
of blocks, on random float32 planes, and timed by CUDA events (mean
of 20 launches, best of 3 rounds, variants in turn within a round). Each
line gives the variant's registers, shared memory and spills as ``ptxas``
reports them, its time at each shape and its share of the float32
operations bound (``chip_smoke.fused_min_ops``). Exits non-zero if a
variant disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "lora_tpu_torch" / "csrc" / "fused_chan.cu"
BUILD = Path(__file__).resolve().parent / "build"
CP_ASYNC = """__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__global__ void __launch_bounds__(kThreads)"""
CP_ASYNC_STAGING = [
    ("__global__ void __launch_bounds__(kThreads)", CP_ASYNC),
    ("        xs[dd * kPitch + q] = in ? make_float2(x[idx], x[x_plane + idx]) : "
     "make_float2(0.f, 0.f);",
     "        cp_async4(&xs[dd * kPitch + q].x, in ? x + idx : x, in);\n"
     "        cp_async4(&xs[dd * kPitch + q].y, in ? x + x_plane + idx : x, in);"),
    ("        gs[(jj * kDc + dd) * kCh + cl] = w;\n      }\n      __syncthreads();",
     "        gs[(jj * kDc + dd) * kCh + cl] = w;\n      }\n"
     "      asm volatile(\"cp.async.commit_group;\\ncp.async.wait_group 0;\\n\" ::: \"memory\");\n"
     "      __syncthreads();"),
]
# timing only: the input is staged for the first stage alone, so later
# stages sum stale samples
STAGE_ONCE = [("      for (int e = tid; e < span * nd; e += kThreads) {\n        const int q",
               "      if (j0 == 0 && d0 == 0)\n"
               "      for (int e = tid; e < span * nd; e += kThreads) {\n        const int q")]
# the kernel; its staging by cp.async; its staging cost; fewer outputs a
# thread, fewer channels a block, more registers a thread (8 outputs x 8
# channels, 4 phases a stage), and twice the threads with half the outputs
VARIANTS = {
    "T128-R4-Ch8-Dc8 (the kernel)": {},
    "cp.async-staging": {"text": CP_ASYNC_STAGING},
    "input-staged-once (timing only)": {"text": STAGE_ONCE, "timing_only": True},
    "T128-R2-Ch8-Dc8": {"kR": 2},
    "T128-R4-Ch4-Dc8": {"kCh": 4},
    "T128-R8-Ch8-Dc4": {"kR": 8, "kDc": 4},
    "T256-R2-Ch8-Dc8": {"kThreads": 256, "kR": 2},
}
# (C, D, taps, n_out): the two plan shapes, and US915 cut to n_out =
# 450,048, whose 879 x 3 = 2,637 blocks fill five waves of 528 (four
# blocks an SM on 132 SMs) where the full shape's 2,643 spill 3 blocks
# into a sixth
PLANS = {"EU868": (7, 8, 77, 450551), "US915": (23, 32, 309, 450551),
         "US915-5-waves": (23, 32, 309, 450048)}


def variant_source(src: str, subs: dict) -> str:
    for key, val in subs.items():
        if key == "timing_only":
            continue
        if key == "text":
            for old, new in val:
                if src.count(old) != 1:
                    raise SystemExit(f"{old!r} is not once in {SRC.name}")
                src = src.replace(old, new)
            continue
        src, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {val};", src)
        if n != 1:
            raise SystemExit(f"constexpr int {key} is not in {SRC.name}")
    return src


def build_variants() -> dict:
    from lora_tpu_torch.ops._build import NVCC_FLAGS, nvcc
    from lora_tpu_torch.ops.cuda_kernels import bind_fused_lib

    BUILD.mkdir(exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        cu = BUILD / f"fused_variant{i}.cu"
        cu.write_text(variant_source(src, subs))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        regs = [ln.strip().replace("ptxas info    : ", "") for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(regs)}")
        libs[name] = bind_fused_lib(ctypes.CDLL(str(so)))
    return libs


def main() -> int:
    import numpy as np
    import torch

    from lora_tpu_torch.channelizer import firdes_low_pass, fused_tables
    from lora_tpu_torch.ops.cuda_kernels import fused_chan_launch, fused_channelize_planes

    cs.phase_device()
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(99)
    shapes = {}
    for plan, (C, D, nt, n_out) in PLANS.items():
        rate = D * 250e3
        L = D * (n_out - 1) + nt
        taps = firdes_low_pass(1.0, rate, 77.5e3, 62.5e3)
        offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
        g2, ramp = fused_tables(offs, rate, taps, D, L, "cuda")
        x = torch.randn((2, L), generator=gen, device="cuda")
        ref = fused_channelize_planes(x, g2, ramp, D, nt, 1024)
        tol = 2 * (g2.shape[1] + 4) * cs.TOL_FUSED_ULPS * float(g2.abs().sum(1).max()) \
            * float(x.abs().max())
        bound = cs.fused_min_ops(C, D, nt, n_out) / cs.F32_FLOPS_PER_S * 1e3
        shapes[plan] = (x, g2, ramp, C, D, nt, n_out, ref, tol, bound)

    best = {(name, plan): float("inf") for name in libs for plan in shapes}
    for plan, (x, g2, ramp, C, D, nt, n_out, ref, tol, _) in shapes.items():
        out = torch.empty((C, 2, n_out), device="cuda")
        for name, lib in libs.items():
            if VARIANTS[name].get("timing_only"):
                continue
            out.zero_()
            fused_chan_launch(lib, x, g2, ramp, D, nt, out)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= tol:
                raise SystemExit(f"{name} {plan}: error {err} > {tol}")
        for _ in range(3):
            for name, lib in libs.items():
                ms = cs.cuda_ms(lambda: fused_chan_launch(lib, x, g2, ramp, D, nt, out), 20)
                best[name, plan] = min(best[name, plan], ms)
    for name in libs:
        print(f"{name}: " + ", ".join(
            f"{plan} {best[name, plan]:.4f} ms ({100 * shapes[plan][-1] / best[name, plan]:.1f} % "
            f"of the {shapes[plan][-1]:.4f} ms operations bound)" for plan in shapes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
