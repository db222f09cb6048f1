#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lora_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card: its name, and name + power limit from ``nvidia-smi``; the
   float32 matmul settings (TF32 off);
2. build every kernel of the main path from ``lora_tpu_torch/csrc``;
3. each kernel against its plain torch version on the card, float32 and
   bfloat16 planes, at the main path's shape and at the ragged and odd
   geometries;
4. the main path at full width: the dense receiver (fft engine) on the
   64-channel x 2048-symbol SF7 @ 1 Msps block, float32 then bfloat16
   planes, with the decode gate and the kernels' launch counts; then
   ``run()`` on a small block, its frames held against the port on the
   CPU;
5. the receiver's throughput (best of rounds of back-to-back calls),
   beside single synchronised calls, the host's enqueue time, the host
   synchronisations in a call and the allocator's device allocations;
6. where one ``process()`` call's device time goes (torch.profiler), and
   the device's idle share; then phase 5 again, after the profiler;
7. each kernel's time beside its bound and its plain version's time.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM data sheet: device-memory rate and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL_CORR_ATOL = 2e-5     # corr: |dot|/sqrt(e e), sums in another order
TOL_ENER_RTOL = 1e-5     # energies: float32 sums of up to 32768 squares


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}")
    print(f"matmul: allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return name, smi_line


def phase_build():
    from lora_tpu_torch.ops._build import build

    for name in ("det_metrics",):
        t0 = time.perf_counter()
        _, log = build(name)
        print(f"build: {name} in {time.perf_counter() - t0:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernel_vs_plain() -> float:
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    # (C, sps, K1, extra tail samples): the bench block, the SF10/SF12
    # shapes, a ragged window count, sps off the 128 grid, and an odd sps
    # (scalar loads)
    geoms = [(64, 1024, 2048, 0), (2, 8192, 16, 0), (2, 32768, 8, 0),
             (3, 1024, 37, 341), (2, 1000, 40, 0), (2, 1001, 9, 5)]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for C, sps, k1, tail in geoms:
            L = k1 * sps + tail
            xf = torch.randn((C, 2, L), generator=gen, device="cuda").to(dtype)
            before = detection_metrics_kernel.launches
            got = detection_metrics_kernel(xf, sps)
            torch.cuda.synchronize()
            check(detection_metrics_kernel.launches == before + 1,
                  "the kernel's launch count did not rise")
            ref = detection_metrics_planes(xf, sps)
            K = k1 - 1
            for g, r in zip(got, ref):
                check(tuple(g.shape) == (C, K), f"shape {tuple(g.shape)} != {(C, K)}")
                check(bool(torch.isfinite(g).all()), "non-finite kernel output")
            err_c = float((got[0] - ref[0]).abs().max())
            err_e = max(float(((g - r).abs() / r.abs()).max())
                        for g, r in zip(got[1:], ref[1:]))
            worst = max(worst, err_c)
            print(f"det_metrics {str(dtype)[6:]} C={C} sps={sps} K1={k1} "
                  f"tail={tail}: corr max abs err {err_c:.3g}, "
                  f"energy max rel err {err_e:.3g}")
            check(err_c <= TOL_CORR_ATOL, f"corr error {err_c} > {TOL_CORR_ATOL}")
            check(err_e <= TOL_ENER_RTOL, f"energy error {err_e} > {TOL_ENER_RTOL}")
    return worst


def bench_block():
    """The dense bench block: SF7 CR4/8 BW125 @ 1 Msps, 64 channels x 2048
    symbols, every channel carrying back-to-back 40 dB packets with a
    per-channel phase offset of 997 samples."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    n_channels, block_symbols = 64, 2048
    block_len = block_symbols * cfg.samples_per_symbol
    pkt = modulate_frame(cfg, bytes.fromhex("deadbeef"), pad_before=4096,
                         pad_after=4096, snr_db=40.0)
    reps = block_len // len(pkt)
    x = np.zeros((n_channels, block_len), np.complex64)
    tiled = np.tile(pkt, max(1, reps))
    for c in range(n_channels):
        n = min(block_len - 997 * c, len(tiled))
        x[c, 997 * c: 997 * c + n] = tiled[:n]
    return cfg, x, n_channels * min(8, reps), len(pkt)


def gate(res, expected: int, label: str) -> int:
    import torch

    valid = res.valid
    n_frames = int(valid.sum())
    pay = res.payload[valid]
    good = (pay[:, :4] == torch.tensor([0xDE, 0xAD, 0xBE, 0xEF], dtype=torch.uint8,
                                       device=pay.device)).all(dim=-1)
    good &= res.length[valid] >= 4
    bad = int((~good).sum())
    for name in ("snr", "cfo"):
        check(bool(torch.isfinite(getattr(res, name)[valid]).all()),
              f"{label}: non-finite {name}")
    print(f"main path {label}: {n_frames}/{expected} frames, {bad} wrong payloads")
    check(n_frames >= 0.9 * expected, f"{label}: decoded {n_frames}/{expected}")
    check(bad == 0, f"{label}: {bad} wrong payloads")
    return n_frames


def phase_main_path(cfg, x, expected):
    import torch

    from lora_tpu_torch import DenseReceiver
    from lora_tpu_torch.ops.cuda_kernels import detection_metrics_kernel
    from lora_tpu_torch.ops.xfer import pack_iq

    rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24, sfd_search=12,
                       demod_method="fft")
    check(rx.device.type == "cuda", "the receiver did not default to the card")
    planes = {}
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = pack_iq(x, dtype=dtype)
        torch.cuda.synchronize()
        detection_metrics_kernel.launches = 0
        res = rx.process(xd)
        torch.cuda.synchronize()
        launches[dtype] = detection_metrics_kernel.launches
        label = str(dtype)[6:]
        check(launches[dtype] > 0, f"{label}: the main path did not launch det_metrics")
        print(f"main path {label}: det_metrics launches {launches[dtype]}")
        check(tuple(res.valid.shape) == (x.shape[0], rx.P), "result shape")
        gate(res, expected, label)
        planes[dtype] = xd
    return rx, planes, launches


def phase_run_small(cfg, x, pkt_len):
    """``run()`` on a small block of whole packets, on the card and on the
    CPU: the frames must agree field by field (the CPU runs the plain
    version of every kernel)."""
    from lora_tpu_torch import DenseReceiver

    small = x[:2, : 2 * pkt_len + 997]
    frames = {}
    for dev in ("cuda", "cpu"):
        rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24,
                           sfd_search=12, demod_method="fft", device=dev)
        frames[dev] = rx.run(small)
    fg, fc = frames["cuda"], frames["cpu"]
    check(len(fg) > 0, "run(): no frames")
    check(len(fg) == len(fc), f"run(): {len(fg)} frames on the card, {len(fc)} on the CPU")
    for a, b in zip(fg, fc):
        check(a.payload[:4] == bytes.fromhex("deadbeef"), "run(): wrong payload")
        check(a.crc_ok is True, "run(): MAC CRC fails")
        check((a.phy_header.to_bytes(), a.payload, a.channel, a.sample_index)
              == (b.phy_header.to_bytes(), b.payload, b.channel, b.sample_index),
              "run(): frame differs from the CPU's")
        check(abs(a.cfo - b.cfo) <= 1.0, "run(): cfo differs from the CPU's")
        check(abs(a.snr - b.snr) <= 1e-4 * abs(b.snr), "run(): snr differs")
    print(f"run(): {len(fg)} frames on a 2-channel block, equal to the CPU's")


def host_syncs(fn) -> list:
    """Host-device synchronisations inside ``fn()``, as torch's sync debug
    mode reports them: one ``file:line: message`` each. The mode's own
    once-a-process notice ("a prototype feature") is not one."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}: {str(w.message)[:80]}" for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_throughput(rx, planes, when, device_name, smi_line):
    """``dense_rx_throughput``: best of 5 rounds of 10 back-to-back
    ``process()`` calls with one synchronise a round. Each round is
    followed by 10 single calls, each between two synchronises, on the
    same planes, so the two timings share the host's state; the line also
    gives the host's own time in a single call (until ``process()``
    returns), the host synchronisations in a call, and the device
    allocations the caching allocator made over the rounds."""
    import torch

    control = host_syncs(lambda: torch.ones(1, device="cuda").item())
    check(len(control) == 1, f"sync debug mode saw {len(control)} syncs in one .item()")
    for dtype, xd in planes.items():
        C, _, L = xd.shape
        iters = 10
        syncs = host_syncs(lambda: rx.process(xd))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        loop_ms, single_ms, enqueue_ms = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                rx.process(xd)
            torch.cuda.synchronize()
            loop_ms.append((time.perf_counter() - t0) * 1e3 / iters)
            for _ in range(iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rx.process(xd)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                single_ms.append((time.perf_counter() - t0) * 1e3)
                enqueue_ms.append((t1 - t0) * 1e3)
        mem1 = torch.cuda.memory_stats()
        print(json.dumps({
            "metric": "dense_rx_throughput", "when": when, "dtype": str(dtype)[6:],
            "value": C * L / min(loop_ms) / 1e3,
            "rounds": [C * L / t / 1e3 for t in loop_ms],
            "unit": "Msamples/s", "block": [C, L],
            "loop_call_ms": loop_ms,
            "single_call_ms_median": sorted(single_ms)[len(single_ms) // 2],
            "single_call_ms_min": min(single_ms),
            "enqueue_ms_median": sorted(enqueue_ms)[len(enqueue_ms) // 2],
            "host_syncs_per_call": len(syncs), "host_syncs": syncs,
            "device_allocs": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                              ("num_device_alloc", "num_device_free",
                               "num_alloc_retries")},
            "device": device_name, "nvidia_smi": smi_line}))


def phase_kernel_times(rx, planes, launches, worst_err):
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes)

    sps = rx.sps
    stats = {}
    for dtype, xd in planes.items():
        C, _, L = xd.shape
        K1 = L // sps
        K = K1 - 1
        # bytes: planes read once, corr and the row energies written once;
        # operations: 12 float32 flops a complex sample (dot re/im, energy)
        t_bytes = (C * 2 * L * xd.element_size() + C * (K + K1) * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = 12 * C * K1 * sps / F32_FLOPS_PER_S * 1e3
        st = dict(ms=cuda_ms(lambda: detection_metrics_kernel(xd, sps), 20),
                  plain_ms=cuda_ms(lambda: detection_metrics_planes(xd, sps), 5),
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
        stats[dtype] = st
        print(f"det_metrics {str(dtype)[6:]} at {list(xd.shape)}: kernel "
              f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
              f"{st['bound_ms']:.4f} ms (bytes {t_bytes:.4f}, ops {t_ops:.4f}), "
              f"launches per process() {launches[dtype]}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    st = stats[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "det_metrics",
        "route": "cuda",
        "source": "lora_tpu_torch/csrc/det_metrics.cu",
        "replaces": "lora_tpu/ops/pallas_kernels.py:85",
        "launches": launches[torch.float32],
        "max_abs_err": worst_err,
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": None,
    }]}))


def call_ms(fn, n: int) -> list:
    """Host-clock times of ``n`` single calls of ``fn()``, each between two
    ``torch.cuda.synchronize()``, in ms."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_profile(rx, planes):
    """Where one ``process()`` call's time goes: device time by kernel name
    (torch.profiler) against the call's wall time; the difference is the
    device's idle share. The idle share is taken against the median
    unprofiled call, since the profiler slows the host's launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for dtype, xd in planes.items():
        wall_ms = sorted(call_ms(lambda: rx.process(xd), 5))[2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms = call_ms(lambda: rx.process(xd), 1)[0]
        # device-side events only: an aten op's entry repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        n_launch = sum(r[2] for r in rows)
        print(f"profile {str(dtype)[6:]}: wall {wall_ms:.3f} ms (median of 5 "
              f"unprofiled calls; {prof_ms:.3f} ms profiled), device busy "
              f"{busy:.3f} ms, idle {100 * (1 - busy / wall_ms):.1f} %, "
              f"{n_launch} device kernels and copies")
        for key, ms, count in rows[:12]:
            print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f} % x{count:<4d} {key[:90]}")


def main() -> int:
    import torch

    import lora_tpu_torch  # noqa: F401  (without the package: fail before any output)

    device_name, smi_line = phase_device()
    phase_build()
    worst = phase_kernel_vs_plain()
    cfg, x, expected, pkt_len = bench_block()
    rx, planes, launches = phase_main_path(cfg, x, expected)
    phase_run_small(cfg, x, pkt_len)
    phase_throughput(rx, planes, "before profile", device_name, smi_line)
    phase_profile(rx, planes)
    phase_throughput(rx, planes, "after profile", device_name, smi_line)
    phase_kernel_times(rx, planes, launches, worst)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
