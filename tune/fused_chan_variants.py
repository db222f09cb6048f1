#!/usr/bin/env python3
"""Time variants of the plan channelizer kernel K5
(``lora_tpu_torch/csrc/fused_chan.cu``) at both plan shapes, on one GPU.

    python3 tune/fused_chan_variants.py [--baseline OLD.cu]

Each variant is the kernel's source with some of its tuning constants
changed (threads a block, channels a block, consecutive outputs a thread,
phases a stage, resident blocks the registers must allow), or, for
timing only, with one part of the kernel cut out by a text substitution
(the restaging of later stages, the mix pass, the tap pass; their sums
are wrong and are not checked). ``--baseline``
adds an older ``fused_chan.cu`` whose C entry takes the folded FIR matrix
g2 in place of the taps and the phase table (the folded-form kernel
before the factored one, e.g. ``git show
<commit>:lora_tpu_torch/csrc/fused_chan.cu``), timed beside the variants.
A constant that is not once in the source stops the script. Every source
is built with the port's ``nvcc`` flags (one ``nvcc`` each, all started
together) into a build directory beside this script and loaded with
ctypes; each line gives the registers, shared memory and spills that
``ptxas`` reports for the instantiation the plan shapes launch (J = 10
tap rows a pass). A variant that does not build is reported and left
out. Each kernel is checked against the plain version
(``fused_channelize_planes``) at the EU868 (C = 7, D = 8, 77 taps) and
US915 (C = 23, D = 32, 309 taps) plan shapes of ``bench.py
--plan-gateway`` (n_out = 450,551, their own taps) and at C = 2, D = 2,
301 taps (K = 151: ten passes of 16 tap rows), on random float32 planes,
with ``chip_smoke.py``'s tolerance; then timed by CUDA events (mean of 20
launches, best of 3 rounds, the kernels in turn within a round) at the
plan shapes. Each line gives the time, the share of the float32
operations bound (``chip_smoke.fused_min_ops``) and, for the factored
kernels, the share of the float32 rate on the operations they issue
(``chip_smoke.fused_kernel_ops``). Exits non-zero if the kernel (the first
variant) does not build or any kernel disagrees with the plain version.
"""

from __future__ import annotations

import argparse
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
# T = kThreads / kCh * kR outputs a block. The timing-only variants drop
# one part of the kernel (their sums are wrong and are not checked): the
# time the kernel loses without it is that part's share that the other
# blocks of an SM do not hide.
VARIANTS = {
    "T256-R16-Ch8-Dc4-B2 (the kernel)": {},
    "T256-R16-Ch8-Dc2-B3": {"kDc": 2, "kMinBlocks": 3},
    "T128-R8-Ch8-Dc4-B3": {"kR": 8, "kMinBlocks": 3},
    "T128-R8-Ch8-Dc8-B2": {"kR": 8, "kDc": 8},
    "staged-once (timing only)": {"text": [(
        "    if (s + 1 < n_stages) issue(s + 1, buf ^ 1);",
        "    if (s + 1 < n_stages && s < 0) issue(s + 1, buf ^ 1);")], "timing_only": True},
    "no-mix-pass (timing only)": {"text": [(
        "      for (int q = tid; q < kRows; q += kThreads) {",
        "      for (int q = tid; q < 0; q += kThreads) {")], "timing_only": True},
    "no-tap-pass (timing only)": {"text": [(
        "      for (int m = 0; m < kR + J - 1; ++m) {",
        "      for (int m = 0; m < 0; ++m) {")], "timing_only": True},
}
BASELINE = "baseline (--baseline source)"
# (C, D, taps, n_out): the two plan shapes; K = 151 (checked, not timed)
PLANS = {"EU868": (7, 8, 77, 450551), "US915": (23, 32, 309, 450551)}
CHECK_ONLY = {"K-151": (2, 2, 301, 2350)}


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
            raise SystemExit(f"constexpr int {key} is not once in {SRC.name}")
    return src


def ptxas_summary(log: str) -> str:
    """``ptxas``'s registers, spills and shared memory of the kernel the
    plan shapes launch: the J = 10 instantiation, or a kernel without
    template arguments (the baseline)."""
    out, keep = [], False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"fused_chan_kernelILi(\d+)EE", m.group(1))
            keep = t is None or t.group(1) == "10"
        elif keep and ("spill" in ln or "registers" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return " | ".join(out)


def build(sources: dict) -> dict:
    from lora_tpu_torch.ops._build import NVCC_FLAGS, nvcc
    from lora_tpu_torch.ops.cuda_kernels import _bind, bind_fused_lib

    BUILD.mkdir(exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = BUILD / f"fused_variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            if name == next(iter(sources)):
                raise SystemExit(f"{name}: nvcc failed:\n{log}")
            print(f"{name}: nvcc failed, left out:\n{log[-2000:]}")
            continue
        print(f"{name}: {ptxas_summary(log)}")
        lib = ctypes.CDLL(str(so))
        # the baseline's C entry: g2 in place of (h, phi)
        libs[name] = bind_fused_lib(lib) if name != BASELINE else _bind(
            lib, "fused_chan",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_void_p])
    return libs


def launcher(name, lib, x, g2, ramp, mix, D, nt, out):
    """``fn()`` launching ``lib``'s kernel on the planes ``x`` into ``out``
    ``[C, 2, n_out]``."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import _check_rc, fused_chan_launch

    if name != BASELINE:
        return lambda: fused_chan_launch(lib, x, ramp, mix, D, nt, out)
    o_re, o_im, i_re, i_im = ramp
    C, _, n_out = out.shape
    args = [x.data_ptr(), x.stride(0), x.shape[-1], g2.data_ptr(), C, D, -(-nt // D),
            o_re.data_ptr(), o_im.data_ptr(), o_re.shape[-1], i_re.data_ptr(), i_im.data_ptr(),
            i_re.shape[-1], out.data_ptr(), n_out]

    def fn():
        _check_rc(lib, "fused_chan", lib.fused_chan_launch(
            *args, torch.cuda.current_stream().cuda_stream))
    return fn


def shape_tables(C, D, nt, n_out, gen):
    """Random planes for ``n_out`` outputs and the tables (the plan taps
    at the plan shapes), with the plain version's output and the
    tolerance."""
    import numpy as np
    import torch

    from lora_tpu_torch.channelizer import firdes_low_pass, fused_tables
    from lora_tpu_torch.ops.cuda_kernels import fused_channelize_planes

    rate = D * 250e3
    L = D * (n_out - 1) + nt
    if (C, D, nt) in ((7, 8, 77), (23, 32, 309)):
        taps = firdes_low_pass(1.0, rate, 77.5e3, 62.5e3)
    else:
        taps = np.random.default_rng(C * 100 + D).normal(0, 0.1, nt).astype(np.float32)
    offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
    g2, ramp, mix = fused_tables(offs, rate, taps, D, L, "cuda")
    x = torch.randn((2, L), generator=gen, device="cuda")
    ref = fused_channelize_planes(x, g2, ramp, D, nt, 1024)
    tol = 2 * (g2.shape[1] + 4) * cs.TOL_FUSED_ULPS * float(g2.abs().sum(1).max()) \
        * float(x.abs().max())
    return x, g2, ramp, mix, ref, tol


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an older fused_chan.cu to time beside")
    args = ap.parse_args()
    cs.phase_device()
    src = SRC.read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.baseline:
        sources[BASELINE] = args.baseline.read_text()
    libs = build(sources)

    gen = torch.Generator(device="cuda").manual_seed(99)
    best = {}
    for plan, (C, D, nt, n_out) in {**CHECK_ONLY, **PLANS}.items():
        x, g2, ramp, mix, ref, tol = shape_tables(C, D, nt, n_out, gen)
        out = torch.empty((C, 2, n_out), device="cuda")
        fns = {name: launcher(name, lib, x, g2, ramp, mix, D, nt, out)
               for name, lib in libs.items()}
        for name, fn in fns.items():
            if VARIANTS.get(name, {}).get("timing_only"):
                continue
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            err = float((out - ref).abs().nan_to_num(float("inf")).max())
            print(f"{plan} {name}: max abs err {err:.3g} (tolerance {tol:.3g})")
            if not err <= tol:
                raise SystemExit(f"{name} {plan}: error {err} > {tol}")
        if plan in CHECK_ONLY:
            continue
        bound = cs.fused_min_ops(C, D, nt, n_out) / cs.F32_FLOPS_PER_S * 1e3
        issued = cs.fused_kernel_ops(C, D, nt, n_out) / cs.F32_FLOPS_PER_S * 1e3
        for _ in range(3):
            for name, fn in fns.items():
                ms = cs.cuda_ms(fn, 20)
                best[name, plan] = min(best.get((name, plan), ms), ms)
        print(f"{plan} (C = {C}, D = {D}, {nt} taps, n_out = {n_out}): operations bound "
              f"{bound:.4f} ms; the kernel's issued float32 operations at the full rate "
              f"{issued:.4f} ms")
        for name in libs:
            ms = best[name, plan]
            rate = "" if name == BASELINE else f", {100 * issued / ms:.1f} % of the float32 rate"
            print(f"  {name}: {ms:.4f} ms, {100 * bound / ms:.1f} % of the bound{rate}")
        del x, g2, ramp, mix, ref, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
