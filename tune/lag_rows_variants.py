#!/usr/bin/env python3
"""Time variants of the multi-lag kernel K3
(``lora_tpu_torch/csrc/lag_rows.cu``) at the gateway's and the US915 plan
gateway's planes, on one GPU.

    python3 tune/lag_rows_variants.py [--baseline OLD.cu]

Each variant is the kernel's source with some of its tuning constants
changed (warps a block, output rows a warp sums a step, steps in flight,
steps a run, resident blocks the registers must allow), or, for timing
only, with one part cut out (the warp's butterfly, the copies into the
ring, the output stores): their sums are wrong and not checked. ``--baseline``
adds an older ``lag_rows.cu`` whose C entry takes contiguous planes only
(no strides, no width argument; e.g. ``git show
<commit>:lora_tpu_torch/csrc/lag_rows.cu``), timed beside the variants on
the contiguous copy of the planes, the only input it takes. A constant
that is not in the source stops the script. Every source is built with
the port's ``nvcc`` flags (one ``nvcc`` each, all started together) into
a build directory beside this script and loaded with ctypes; each
variant's line gives the registers, shared memory and spills that
``ptxas`` reports for its instantiations.

Shapes, with the gateway's lags 1-32 and rows of 256 samples: the
gateway's bf16 channel planes as the channelizer leaves them, a view
``[256, 2, 450551]`` of a ``[256, 2, 450552]`` buffer (16-byte copies),
and the US915 plan gateway's contiguous float32 planes ``[23, 2,
450551]`` (4-byte copies). Each kernel is first held to the plain version
(``lag_rows_planes``) within ``chip_smoke.TOL_LAG_E_RTOL`` and
``TOL_LAG_Q`` on random planes at both shapes, then timed by CUDA events
(mean of 20 launches, best of 3 rounds, the kernels in turn within a
round). Each shape's line gives the bound, the plain version's time and
the time of a ``contiguous()`` copy of the planes (what the gateway paid
before the kernel read its view); each kernel's line its time and share
of the bound. Exits non-zero if a kernel disagrees with the plain
version.
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

SRC = ROOT / "lora_tpu_torch" / "csrc" / "lag_rows.cu"
BUILD = Path(__file__).resolve().parent / "build"
VARIANTS = {
    "W8-G1-D1-R32-B3 (the kernel)": {},
    "W8-G1-D2-R32-B2": {"kDepth": 2, "kMinBlocks": 2},
    "W8-G1-D2-R32-B3": {"kDepth": 2},
    "W8-G1-D1-R32-B2": {"kMinBlocks": 2},
    "W8-G1-D1-R32-B4": {"kMinBlocks": 4},
    "W8-G1-D1-R16-B3": {"kRunSteps": 16},
    "W8-G2-D1-R32-B3": {"kRowsPerWarp": 2},
    "W4-G1-D1-R32-B5": {"kWarps": 4, "kMinBlocks": 5},
    # timing only (their sums are wrong): one part of the kernel cut out
    "cut: the lane sums its 16 values, no butterfly (timing only)": {"text": [
        ("const float total = warp_sums(acc, lane);",
         "float total = 0.f;\n#pragma unroll\n"
         "    for (int j = 0; j < kSums; ++j) total += acc[j];")]},
    "cut: no copies into the ring (timing only)": {"text": [
        ("          cp_async16(dst, src);", "          (void)src;"),
        ("          cp_async4(dst, src);", "          (void)src;")]},
    "cut: no output stores (timing only)": {"text": [
        ("      *o = t0 == 0 ? total : *o + total;", "      if (total == 1234.5f) *o = total;")]},
}
BASELINE = "baseline (--baseline source, contiguous copy)"
N_ROWS, SPS, L = 1759, 256, 450_551


def variant_source(src: str, subs: dict) -> str:
    for key, val in subs.items():
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


def ptxas_summary(log: str) -> str:
    """``ptxas``'s registers, spills and shared memory by instantiation."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"lag_rows_kernelI(\w+?)EEv", m.group(1))
            name = t.group(1) if t else m.group(1)
        elif name and ("spill" in ln or "registers" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return " | ".join(out)


def build(sources: dict) -> dict:
    from lora_tpu_torch.ops._build import NVCC_FLAGS, nvcc
    from lora_tpu_torch.ops.cuda_kernels import _bind, bind_lag_lib

    BUILD.mkdir(exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = BUILD / f"lag_variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        print(f"{name}: {ptxas_summary(log)}")
        lib = ctypes.CDLL(str(so))
        # the baseline's C entry: contiguous planes, no strides, no width
        libs[name] = bind_lag_lib(lib) if name != BASELINE else _bind(
            lib, "lag_rows", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return libs


def launcher(name, lib, x, xc, lags, out):
    """``fn()`` launching ``lib``'s kernel into ``out``: on the planes ``x``
    as the path holds them (the wrapper's width choice), or for the
    baseline on their contiguous copy ``xc``."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (_DTYPE_CODE, _check_rc, _lag_table,
                                                 lag_rows_launch)

    if name != BASELINE:
        return lambda: lag_rows_launch(lib, x, SPS, lags, out)
    C, _, n = xc.shape
    args = [xc.data_ptr(), _lag_table(lags, xc.device).data_ptr(), out.data_ptr(), C, n, SPS,
            len(lags), lags[-1], _DTYPE_CODE[xc.dtype]]

    def fn():
        _check_rc(lib, "lag_rows", lib.lag_rows_launch(
            *args, torch.cuda.current_stream().cuda_stream))
    return fn


def main() -> int:
    import torch

    from lora_tpu_torch.ops.cuda_kernels import _lag_vector_width, lag_rows_planes

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an older lag_rows.cu to time beside")
    args = ap.parse_args()
    cs.phase_device()
    src = SRC.read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.baseline:
        sources[BASELINE] = args.baseline.read_text()
    libs = build(sources)

    lags = cs.GATEWAY_LAGS
    gen = torch.Generator(device="cuda").manual_seed(5)
    # (label, channels, dtype, plane pitch)
    shapes = [("gateway view", 256, torch.bfloat16, L + 1), ("plan US915", 23, torch.float32, L)]
    worst = {}
    for label, C, dtype, pitch in shapes:
        x = torch.randn((C, 2, pitch), generator=gen, device="cuda").to(dtype)[..., :L]
        xc = x.contiguous()
        ref = lag_rows_planes(x, SPS, lags)
        out = torch.empty((C, 1 + 2 * len(lags), N_ROWS), device="cuda")
        fns = {name: launcher(name, lib, x, xc, lags, out) for name, lib in libs.items()}
        for name, fn in fns.items():
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            got = (out[:, 0], {m: (out[:, 1 + 2 * s], out[:, 2 + 2 * s])
                               for s, m in enumerate(lags)})
            if "timing only" in name:
                continue
            err_abs, err_e, err_q = cs.lag_rows_errors(got, ref, lags)
            worst[name] = max(worst.get(name, 0.0), err_abs)
            cs.check(bool(torch.isfinite(out).all()) and err_e <= cs.TOL_LAG_E_RTOL
                     and err_q <= cs.TOL_LAG_Q,
                     f"{name} {label}: disagrees with the plain version (energy {err_e:.3g}, "
                     f"lag {err_q:.3g})")
        bound, t_bytes, t_ops, by = cs.lag_bound(x.shape, x.element_size(), SPS, lags)
        plain = cs.cuda_ms(lambda: lag_rows_planes(x, SPS, lags), 3)
        copy = cs.cuda_ms(lambda: x.contiguous(), 20)
        print(f"{label} {str(dtype)[6:]} {list(x.shape)} plane stride {x.stride(1)}: the "
              f"kernel's copies move {_lag_vector_width(x, SPS)} samples; every kernel but the "
              f"cuts within tolerance; bound {bound:.4f} ms (bytes {t_bytes:.4f}, ops {t_ops:.4f}; "
              f"{by}), plain {plain:.4f} ms, contiguous() of the planes {copy:.4f} ms")
        best = {}
        for _ in range(3):
            for name, fn in fns.items():
                ms = cs.cuda_ms(fn, 20)
                best.setdefault(name, []).append(ms)
        for name, ms in best.items():
            print(f"  {name}: {min(ms):.4f} ms (rounds {', '.join(f'{t:.4f}' for t in ms)}), "
                  f"{100 * bound / min(ms):.1f} % of the bound")
        del x, xc, ref, out
        torch.cuda.empty_cache()
    print("max abs err against the plain version: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
