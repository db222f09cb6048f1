#!/usr/bin/env python3
"""Time variants of the polyphase branch FIR kernel K4
(``lora_tpu_torch/csrc/pfb_fir.cu``) at the path's shapes, on one GPU.

    python3 tune/pfb_fir_variants.py [--variants NAME,...] [--parent OLD.cu]
                                     [--baseline OLD.cu] [--shapes LABEL,...]

Each variant is the kernel's source with some of its tuning constants
changed (threads a block, float32 sums a thread, steps in flight, steps a
run, resident blocks the registers must allow, a narrow ring's padding
rows), or a probe: a text change that breaks the result to time a part
(the narrow kernel without its output stores), timed but not checked;
``--variants`` keeps only the named ones (the kernel itself is always
built). ``--parent`` adds an older ``pfb_fir.cu`` with the same C
entry (e.g. ``git show HEAD:lora_tpu_torch/csrc/pfb_fir.cu`` before a
change), timed in turns beside the variants; ``--baseline`` one whose C
entry has no vector-width argument (the register-window kernel before the
streaming one). A constant that is not in the source stops the script.
Every source is built with the port's ``nvcc`` flags (one ``nvcc`` each,
all started together) into a build directory beside this script and
loaded with ctypes; each variant's line gives the registers, shared memory
and spills that ``ptxas`` reports for its float32-in instantiations. Each
kernel but a probe is held bit-equal to the plain version
(``pfb_fir_planes``) at every timed shape and at other geometries (an odd
plane stride, M = 1001; the narrow tiles M = 1, 2, 4, 8, 16 at K = 13, in
every dtype pair), then timed by CUDA events (mean of 20 launches, best
of 3 rounds, the kernels in turn within a round) at: wideband-1024
float32 -> float32 and float32 -> bfloat16 (M = 1024, n_vec = 24,576, K =
10), gateway-256 float32 -> bfloat16 (M = 256, n_vec = 450,560, K = 10),
each with the receivers' own taps, and the subband path's coarse
filterbank (float32 -> float32, K = 13, its prototype at M = 8, 4 and 1,
8,355,952 samples a plane: one shard's block and halo), on random planes; ``--shapes`` keeps the shapes whose
label starts with one of the names given. Each shape's line also gives the
kernel's launch geometry (threads across, row groups, rows a step, ring
rows and bytes, blocks) beside a warp-wide launcher's, the bytes and operations bounds, the plain
version's time and the ``conv1d(groups=M)`` yardstick's
(``chip_smoke.pfb_times``), and the time and rate of a device-to-device
copy of the planes (the rate the memory reaches on a plain stream of reads
and writes); each kernel's line its time, share of the bound and bytes
rate. Exits non-zero if a kernel disagrees with the plain version.
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
    "T256-A32-D2-R32": {"kThreadsLog2": 8, "kMinBlocks": 2},
    "T256-A32-D1-R32": {"kThreadsLog2": 8, "kMinBlocks": 2, "kDepth": 1},
    "no narrow padding": {"kPadRows": 0},
    # a probe, not a kernel: the narrow kernel with its output stores
    # skipped (a condition no output meets), timing the rest of it
    "narrow: no output stores": {"_text": [(
        "if (mq < M && t_step + r < n_out)\n",
        "if (mq < M && t_step + r < n_out && acc[0][0] == 1234.5f)\n")]},
}
PROBES = {"narrow: no output stores"}   # variants whose output is not checked
BASELINE = "baseline (--baseline source)"
PARENT = "parent (--parent source)"
KERNEL = next(iter(VARIANTS))
# (label, M, n_vec, in dtype, out dtype): the receivers' taps (K = 10), or
# the subband path's coarse prototype (K = 13) for a "coarse" label
COARSE_SAMPLES = 8355952
SHAPES = [("wideband-1024", 1024, 24576, "float32", "float32"),
          ("wideband-1024", 1024, 24576, "float32", "bfloat16"),
          ("gateway-256", 256, 450560, "float32", "bfloat16"),
          ("coarse-8", 8, COARSE_SAMPLES // 8, "float32", "float32"),
          ("coarse-4", 4, COARSE_SAMPLES // 4, "float32", "float32"),
          ("coarse-1", 1, COARSE_SAMPLES, "float32", "float32")]


def variant_source(src: str, subs: dict) -> str:
    for key, val in subs.items():
        if key == "_text":
            for old, new in val:
                if src.count(old) != 1:
                    raise SystemExit(f"{old!r} is not in {SRC.name} once")
                src = src.replace(old, new)
            continue
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
        if name in PROBES:
            continue
        out.fill_(float("nan"))
        launcher(name, lib, x, h, out)()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = float((out.float() - ref.float()).abs().nan_to_num(float("inf")).max())
            raise SystemExit(f"{name} {label}: not bit-equal to the plain version ({err})")
    print(f"{label}: all {len(set(libs) - PROBES)} kernels bit-equal to the plain version")


def coarse_taps(n: int, device):
    """The subband path's coarse prototype at ``n`` subbands
    (``parallel/sharding.py``: K = 13), as ``[K, n]`` taps."""
    from lora_tpu_torch.channelizer import PolyphaseChannelizer, firdes_low_pass

    rate = 250e3 * 1280 * n
    return PolyphaseChannelizer(n, firdes_low_pass(1.0, rate, 0.42 * rate / n, rate / n / 5.0),
                                device=device)._h


def warp_tile_geometry(M: int, K: int, vec: int, size: int) -> str:
    """The tile of a launcher whose tiles are never narrower than a warp
    (Tc = the fewest of 32, 64, 128 threads across that cover M, G = 128 /
    Tc), as the kernel had before its narrow tile: a wide tile's must be
    the same."""
    kR = 32 // vec
    tc = 32
    while tc < 128 and tc * vec < M:
        tc *= 2
    S = 128 // tc * kR
    return f"Tc {tc}, G {128 // tc}, S {S}, ring bytes {(K - 1 + 3 * S) * tc * vec * size}"


def main() -> int:
    import torch

    from lora_tpu_torch.channelizer import PolyphaseChannelizer
    from lora_tpu_torch.ops.cuda_kernels import pfb_fir_geometry

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", help="comma-separated variant names to build beside the kernel")
    ap.add_argument("--parent", type=Path, help="an older pfb_fir.cu with the same C entry")
    ap.add_argument("--baseline", type=Path, help="an older pfb_fir.cu without a width argument")
    ap.add_argument("--shapes", help="comma-separated shape label prefixes to time")
    args = ap.parse_args()
    cs.phase_device()
    src = SRC.read_text()
    keep = set(args.variants.split(",")) | {KERNEL} if args.variants else set(VARIANTS)
    unknown = keep - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    sources = {name: variant_source(src, subs) for name, subs in VARIANTS.items() if name in keep}
    if args.parent:
        sources[PARENT] = args.parent.read_text()
    if args.baseline:
        sources[BASELINE] = args.baseline.read_text()
    libs = build(sources)
    shapes = [s for s in SHAPES
              if not args.shapes or any(s[0].startswith(p) for p in args.shapes.split(","))]

    gen = torch.Generator(device="cuda").manual_seed(8)
    # (M, n_vec, K, plane stride one sample longer): the scalar
    # instantiation (an odd stride, M = 1001), the narrow tiles
    for M, n_vec, K, odd in ((256, 400, 10, True), (1001, 300, 10, False), (1, 9000, 13, False),
                             (2, 5000, 13, False), (4, 4000, 13, False), (8, 3001, 13, False),
                             (16, 1500, 13, False), (8, 13, 13, False)):
        x32 = torch.randn((2, n_vec * M + odd), generator=gen, device="cuda")
        h = 0.1 * torch.randn((K, M), generator=gen, device="cuda")
        for in_dtype in (torch.float32, torch.bfloat16):
            for out_dtype in (torch.float32, torch.bfloat16):
                check_equal(libs, x32.to(in_dtype)[:, :n_vec * M], h, out_dtype,
                            f"M={M} n_vec={n_vec} K={K} plane stride {n_vec * M + odd} "
                            f"{str(in_dtype)[6:]}->{str(out_dtype)[6:]}")
    best = {}
    for label, M, n_vec, in_dt, out_dt in shapes:
        h = (coarse_taps(M, "cuda") if label.startswith("coarse")
             else PolyphaseChannelizer.for_lora(M * 250e3, M, device="cuda")._h)
        x = torch.randn((2, n_vec * M), generator=gen, device="cuda").to(getattr(torch, in_dt))
        out_dtype = getattr(torch, out_dt)
        check_equal(libs, x, h, out_dtype, f"{label} {in_dt}->{out_dt}")
        out = torch.empty((n_vec - h.shape[0] + 1, 2, M), dtype=out_dtype, device="cuda")
        geo = pfb_fir_geometry(libs[KERNEL], x, h, out)
        print(f"{label} {in_dt}->{out_dt}: the kernel's geometry "
              + ", ".join(f"{k} {v}" for k, v in geo.items())
              + "; the warp-wide launcher's "
              + warp_tile_geometry(M, h.shape[0], geo["vec"], x.element_size()))
        fns = {name: launcher(name, lib, x, h, out) for name, lib in libs.items()}
        st = cs.pfb_times(x, h, out_dtype, kernel=fns[KERNEL])
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
