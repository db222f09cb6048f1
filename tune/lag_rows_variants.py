#!/usr/bin/env python3
"""Time variants of the multi-lag kernel (``lora_tpu_torch/csrc/lag_rows.cu``)
at the gateway's shape, on one GPU.

    python3 tune/lag_rows_variants.py

Each variant is the kernel's source with some of its tuning constants
changed (column tile, blocks an SM); every variant is built with the
port's ``nvcc`` flags (one ``nvcc`` each, all started together) into a
build directory beside this script, loaded with ctypes, checked against
the plain version (``lag_rows_planes``) on random bf16 and float32
planes ``[256, 2, 450551]`` with rows of 256 and the gateway's lags
1-32, and timed by CUDA events (mean of 20 launches, best of 3 rounds).
Each line gives the variant's registers and spills as ``ptxas`` reports
them, its time, and the largest absolute, energy-relative and
Cauchy-Schwarz-scaled lag-product errors; the six per-SF detection
launches the kernel replaces are timed beside it. Exits non-zero if a
variant disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "lora_tpu_torch" / "csrc" / "lag_rows.cu"
BUILD = Path(__file__).resolve().parent / "build"
COLS = "constexpr int kCols = 8; "
BLOCKS = "constexpr int kMinBlocks = 3;"
VARIANTS = {
    "cols8-blocks3 (the kernel)": [],
    "cols8-blocks2": [(BLOCKS, "constexpr int kMinBlocks = 2;")],
    "cols16-blocks2": [(COLS, "constexpr int kCols = 16;"), (BLOCKS, "constexpr int kMinBlocks = 2;")],
    "cols16-blocks3": [(COLS, "constexpr int kCols = 16;")],
}


def build_variants() -> dict:
    from lora_tpu_torch.ops._build import NVCC_FLAGS, nvcc

    BUILD.mkdir(exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {SRC.name}")
            text = text.replace(old, new)
        cu = BUILD / f"variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        lib.lag_rows_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.lag_rows_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from lora_tpu_torch.ops.cuda_kernels import detection_metrics_kernel, lag_rows_planes

    cs.phase_device()
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(5)
    C, sps, L = 256, 256, 450_551
    R = L // sps
    lags = cs.GATEWAY_LAGS
    lag_t = torch.tensor(lags, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((C, 2, L), generator=gen, device="cuda").to(dtype)
        ref = lag_rows_planes(x, sps, lags)
        six = cs.cuda_ms(lambda: [detection_metrics_kernel(x, m * sps) for m in lags], 10)
        print(f"{str(dtype)[6:]} [{C}, 2, {L}]: six per-SF det_metrics launches {six:.4f} ms")
        for name, lib in libs.items():
            out = torch.empty((C, 1 + 2 * len(lags), R), device="cuda")

            def launch():
                rc = lib.lag_rows_launch(x.data_ptr(), lag_t.data_ptr(), out.data_ptr(), C, L,
                                         sps, len(lags), max(lags),
                                         0 if dtype == torch.float32 else 1,
                                         torch.cuda.current_stream().cuda_stream)
                cs.check(rc == 0, f"{name}: launch failed ({rc})")

            launch()
            torch.cuda.synchronize()
            got = (out[:, 0], {m: (out[:, 1 + 2 * s], out[:, 2 + 2 * s])
                               for s, m in enumerate(lags)})
            err_abs, err_e, err_q = cs.lag_rows_errors(got, ref, lags)
            ms = [cs.cuda_ms(launch, 20) for _ in range(3)]
            print(f"  {name}: {min(ms):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in ms)}); "
                  f"max abs err {err_abs:.3g}, energy rel {err_e:.3g}, lag / sqrt(e e) {err_q:.3g}")
            cs.check(err_e <= cs.TOL_LAG_E_RTOL and err_q <= cs.TOL_LAG_Q,
                     f"{name}: disagrees with the plain version")
        del x, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
