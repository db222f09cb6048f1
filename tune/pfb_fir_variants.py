#!/usr/bin/env python3
"""Time variants of the polyphase branch FIR kernel K4
(``lora_tpu_torch/csrc/pfb_fir.cu``) at the path's three shapes, on one
GPU.

    python3 tune/pfb_fir_variants.py [--baseline OLD.cu]

Each variant is the kernel's source with some of its tuning constants
changed (threads a block, float32 sums a thread, steps in flight, steps a
run, resident blocks the registers must allow). ``--baseline`` adds an
older ``pfb_fir.cu`` whose C entry has no vector-width argument (the
register-window kernel before the streaming one, e.g. ``git show
<commit>:lora_tpu_torch/csrc/pfb_fir.cu``), timed beside the variants. A
constant that is not in the source stops the script. Every source is built
with the port's ``nvcc`` flags (one ``nvcc`` each, all started together)
into a build directory beside this script and loaded with ctypes; each
variant's line gives the registers, shared memory and spills that
``ptxas`` reports for its float32-in instantiations. Each kernel is held
bit-equal to the plain version (``pfb_fir_planes``) at the three shapes
and at scalar-instantiation geometries (an odd plane stride, M = 1001),
then timed by CUDA events (mean of 20 launches, best of 3 rounds, the
kernels in turn within a round) at: wideband-1024 float32 -> float32 and
float32 -> bfloat16 (M = 1024, n_vec = 24,576, K = 10) and gateway-256
float32 -> bfloat16 (M = 256, n_vec = 450,560, K = 10), each with the
receivers' own taps and random planes. Each shape's line also gives the
bytes and operations bounds, the plain version's time and the
``conv1d(groups=M)`` yardstick's (``chip_smoke.pfb_times``), and the
time and rate of a device-to-device copy of the planes (the rate the
memory reaches on a plain stream of reads and writes); each kernel's line
its time, share of the bound and bytes rate. Exits
non-zero if a kernel disagrees with the plain version.
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

SRC = ROOT / "lora_tpu_torch" / "csrc" / "pfb_fir.cu"
BUILD = Path(__file__).resolve().parent / "build"
VARIANTS = {
    "T128-A32-D2-R32 (the kernel)": {},
    "T128-A32-D1-R32": {"kDepth": 1},
    "T128-A32-D3-R32": {"kDepth": 3},
    "T128-A16-D2-R32": {"kAcc": 16},
    "T128-A64-D2-R32": {"kAcc": 64},
    "T128-A32-D2-R16": {"kRunSteps": 16},
    "T128-A32-D2-R64": {"kRunSteps": 64},
    "T256-A32-D2-R32": {"kThreads": 256, "kMinBlocks": 2},
    "T256-A32-D1-R32": {"kThreads": 256, "kMinBlocks": 2, "kDepth": 1},
}
BASELINE = "baseline (--baseline source)"
# (label, M, n_vec, in dtype, out dtype); K = 10, the receivers' taps
SHAPES = [("wideband-1024", 1024, 24576, "float32", "float32"),
          ("wideband-1024", 1024, 24576, "float32", "bfloat16"),
          ("gateway-256", 256, 450560, "float32", "bfloat16")]


def variant_source(src: str, subs: dict) -> str:
    for key, val in subs.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {val};", src)
        if n != 1:
            raise SystemExit(f"constexpr int {key} is not in {SRC.name}")
    return src


def ptxas_summary(log: str) -> str:
    """``ptxas``'s registers, spills and shared memory of the float32-in
    instantiations, by template arguments."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"pfb_fir_kernelI(\w+?)EEvPK", m.group(1))
            name = t.group(1) if t else m.group(1)
        elif name and ("spill" in ln or "registers" in ln) and name.startswith("f"):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return " | ".join(out)


def build(sources: dict) -> dict:
    from lora_tpu_torch.ops._build import NVCC_FLAGS, nvcc
    from lora_tpu_torch.ops.cuda_kernels import _bind, bind_pfb_lib

    BUILD.mkdir(exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = BUILD / f"pfb_variant{i}.cu"
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
        # the baseline's C entry: no vector-width argument
        libs[name] = bind_pfb_lib(lib) if name != BASELINE else _bind(
            lib, "pfb_fir", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return libs


def launcher(name, lib, x, h, out):
    """``fn()`` launching ``lib``'s kernel on ``x``, ``h`` into ``out``
    ``[n_out, 2, M]`` (the wrapper's layout and width choice)."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import _DTYPE_CODE, _check_rc, pfb_fir_launch

    if name != BASELINE:
        return lambda: pfb_fir_launch(lib, x, h, out)
    K, M = h.shape
    args = [x.data_ptr(), h.data_ptr(), out.data_ptr(), M, K, x.shape[-1] // M, x.stride(0),
            M, 2 * M, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out.dtype]]

    def fn():
        _check_rc(lib, "pfb_fir", lib.pfb_fir_launch(
            *args, torch.cuda.current_stream().cuda_stream))
    return fn


def check_equal(libs, x, h, out_dtype, label: str) -> None:
    import torch

    from lora_tpu_torch.ops.cuda_kernels import pfb_fir_planes

    K, M = h.shape
    n_out = x.shape[-1] // M - K + 1
    ref = pfb_fir_planes(x, h, out_dtype).transpose(0, 1)
    out = torch.empty((n_out, 2, M), dtype=out_dtype, device=x.device)
    for name, lib in libs.items():
        out.fill_(float("nan"))
        launcher(name, lib, x, h, out)()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = float((out.float() - ref.float()).abs().nan_to_num(float("inf")).max())
            raise SystemExit(f"{name} {label}: not bit-equal to the plain version ({err})")
    print(f"{label}: all {len(libs)} kernels bit-equal to the plain version")


def main() -> int:
    import torch

    from lora_tpu_torch.channelizer import PolyphaseChannelizer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="an older pfb_fir.cu to time beside")
    args = ap.parse_args()
    cs.phase_device()
    src = SRC.read_text()
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items()}
    if args.baseline:
        sources[BASELINE] = args.baseline.read_text()
    libs = build(sources)

    gen = torch.Generator(device="cuda").manual_seed(8)
    for M, n_vec, odd in ((256, 400, True), (1001, 300, False)):
        x32 = torch.randn((2, n_vec * M + odd), generator=gen, device="cuda")
        h = 0.1 * torch.randn((10, M), generator=gen, device="cuda")
        for in_dtype in (torch.float32, torch.bfloat16):
            for out_dtype in (torch.float32, torch.bfloat16):
                check_equal(libs, x32.to(in_dtype)[:, :n_vec * M], h, out_dtype,
                            f"M={M} n_vec={n_vec} plane stride {n_vec * M + odd} "
                            f"{str(in_dtype)[6:]}->{str(out_dtype)[6:]} (scalar)")
    best = {}
    for label, M, n_vec, in_dt, out_dt in SHAPES:
        h = PolyphaseChannelizer.for_lora(M * 250e3, M, device="cuda")._h
        x = torch.randn((2, n_vec * M), generator=gen, device="cuda").to(getattr(torch, in_dt))
        out_dtype = getattr(torch, out_dt)
        check_equal(libs, x, h, out_dtype, f"{label} {in_dt}->{out_dt}")
        out = torch.empty((n_vec - h.shape[0] + 1, 2, M), dtype=out_dtype, device="cuda")
        fns = {name: launcher(name, lib, x, h, out) for name, lib in libs.items()}
        st = cs.pfb_times(x, h, out_dtype, kernel=fns[next(iter(VARIANTS))])
        cs.print_pfb_times(label, st, "kernel: the first variant")
        # the memory system's yardstick: a device-to-device copy of the planes
        dst = torch.empty_like(x)
        copy_ms = cs.cuda_ms(lambda: dst.copy_(x), 20)
        del dst
        print(f"  copy of the planes ({x.numel() * x.element_size() / 1e6:.1f} MB read, as many "
              f"written): {copy_ms:.4f} ms, {2 * x.numel() * x.element_size() / copy_ms / 1e9:.3f}"
              f" TB/s")
        key = (label, in_dt, out_dt)
        for _ in range(3):
            for name, fn in fns.items():
                ms = cs.cuda_ms(fn, 20)
                best[name, key] = min(best.get((name, key), ms), ms)
        for name in libs:
            ms = best[name, key]
            print(f"  {name}: {ms:.4f} ms, {100 * st['bound_ms'] / ms:.1f} % of the "
                  f"{st['bound_ms']:.4f} ms bound ({st['bound_by']}), "
                  f"{st['t_bytes'] * cs.HBM_BYTES_PER_S / ms / 1e12:.3f} TB/s")
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
