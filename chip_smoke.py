#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lora_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. the card: its name, and name + power limit from ``nvidia-smi``; the
   float32 matmul settings (TF32 off);
2. build every kernel from ``lora_tpu_torch/csrc`` (six sources), one
   ``nvcc`` per source, all started together; then, while the card's
   memory is fresh, the bench (``phase_bench``): ``python -m
   lora_tpu_torch.bench``, every stage of ``bench.py`` in its own
   process, must exit 0 and print its nine metric lines once each, in
   ``bench.py``'s order, with ``decode_ratio`` 1.0 and ``n_dropped`` 0
   wherever they print; then ``python -m lora_tpu_torch.cli bench`` its
   two dense lines; each line is printed behind ``bench:``;
3. each kernel against its plain torch version on the card, float32 and
   bfloat16, at the main paths' shapes and at ragged and odd geometries
   (the polyphase FIR bit-equal, in its vector and scalar
   instantiations and its wide and narrow tiles (M = 1-16 and 124), the
   gateway's shape included; the multi-lag kernel
   also at both plan gateways' planes and on pitched views as the
   channelizer leaves them, through its 16-byte and scalar copies, sps =
   4096 in column chunks and lags past its ring, each launched twice,
   bit-identical; the fused plan channelizer,
   float32 only, at both plan shapes, a ragged L, C = 1, D = 2, D = 1
   and past the TPU kernel's gate); the detection
   metric's staged "tile" kernel and its window-major kernel at the same
   shapes as the "pp" kernel, the dense bench block's included;
4. the dense path at full width: the dense receiver (fft engine) on the
   64-channel x 2048-symbol SF7 @ 1 Msps block, float32 then bfloat16
   planes, with the decode gate and the kernels' launch counts; then
   ``run()`` on a small block, its frames held against the port on the
   CPU;
5. the wideband path at full width, on captures built on the card: the
   PFB receiver with the global candidate pool at M = 1024 (64 active
   channels, float32 and bfloat16 planes; then all 1024 channels active)
   and at M = 4096 (the two-stage DFT), with the decode gates and the
   kernels' launch counts; then ``run()`` on a small capture, held
   against the CPU;
6. the multi-SF gateway at full width (``bench.py --gateway 256``: 256
   channels x SF7-12, bf16 planes) on a capture built on the card, with
   the decode gate and the launch counts of the shared detection (one
   multi-lag kernel) and of the per-SF detection (six detection
   kernels), which must decode the same lanes; then ``run()`` on a small
   capture, held against the CPU;
7. the LoRaWAN plan gateway at full width (``bench.py --plan-gateway``:
   EU868 at 2 Msps, 7 channels, then US915 at 8 Msps, 23 channels, SF7-12
   each, float32 planes) on captures built on the card, with the decode
   gate (every placement decodes at its own SF and channel) and the
   launch counts (one fused channelizer and one multi-lag kernel a call);
   at EU868 again with the factored channelizer (``fused=False``), which
   must decode the same lanes; then ``run()`` on a small capture, held
   against the CPU;
8. each path's throughput (best of rounds of back-to-back calls), beside
   single synchronised calls, the host's enqueue time, the host
   synchronisations in a call and the allocator's device allocations;
9. where one call's device time goes (torch.profiler), and the device's
   idle share, by layer for the wideband, gateway and US915 plan calls
   (the gateway's channel planes reach K3 and every SF's Phase B
   uncopied); then phase 8 again, after the profiler;
10. the kernel studies at their defaults (``lora_tpu_torch.tools``:
   ``profile_detect``, "pp" against "tile"; ``profile_packing``,
   plane-major against window-major), each launching its kernels once a
   call; the per-stage timing study (``profiling.timing_table()`` at the
   CLI defaults, every stage > 0, its detect stage through the "pp"
   kernel) and ``pfb_timings(1024)``; the gradient engine on the dense
   bench block (the decode gate, ``run()`` against the CPU, its median
   call beside the fft engine's);
11. streaming on the card (``lora_tpu_torch.stream``), each path a
   capture of at least three blocks with packets across block seams,
   pushed in chunks of an odd size through the native sample ring, with
   every count zeroed just before it and read just after (each kernel of
   the path once a block), no host synchronisation in a block's enqueue
   and one in its drain: (a) ``StreamingReceiver`` on the dense geometry
   (the bench block's rows end to end, 134,217,728 samples); (b)
   ``WidebandStreamingReceiver`` on the wideband receiver at M = 1024; (c)
   the same on the EU868 plan gateway, SF7-12, 2 Msps; each gated (every
   packet decoded exactly once, at its placement, with its payload, and
   no other frame) and held to one ``run()`` of the whole capture, with
   its streamed rate; the ring's write and peek rates and a block's
   host-to-card copy, pinned ``non_blocking`` against pageable; the
   device's idle share over the streamed plan run; (d) ``python -m
   lora_tpu_torch.cli gateway --plan EU868 --stream`` (its ``main``) on a
   file of (c)'s capture, whose lines must be (c)'s frames;
12. the receiver facade and the modes of this slice on the card: (a)
   ``LoRaReceiver(engine="dense")`` at SF7 CR4/8, 1 Msps, one channel
   (``freq_xlating_fir``) and three (``channelize_list``) of a capture
   with six packets a channel, every packet decoded, one K1 launch a
   ``receive()``, the frames equal to the same facade's on the CPU, the
   median ``receive()``; K1 at the facade's planes against its plain
   version; (b) the accuracy suites ``short_sim``, ``short_sim_implicit``
   and ``short_sim_sdr`` (72 traces, 384 packets each) from the port's
   generator, run by its ``run_suite(engine="dense")``, each 384/384, with
   their generation and decode seconds, then deleted; (c) ``low_snr`` at
   SF7 / 250 ksps, -4 dB (6/6) and SF12 / 250 ksps, -16 dB (4/4, the 64M
   fold budget), no K1 launch, frames equal to the CPU's, and the facade's
   ``low_snr="auto"`` second pass; (d) implicit headers on both engines
   (CR 4/5-4/8) and ``debug_trace`` of both engines against the CPU;
13. the parity engine on the card (``phase_parity``):
   ``LoRaReceiver(engine="parity")`` on the facade capture, one channel and
   three in one batched loop, 6/6 and 18/18, frames equal to the golden
   facade's and the CPU's, at most one host sync a loop step, the steps,
   device kernels a step and the median ``receive()``; ``short_sim``
   through ``run_suite(engine="parity")`` (384/384); the clamped demod
   buffer's final state against the CPU's; the SF13 sliding sync against
   the CPU's, with its device memory;
14. flowgraphs on the card (``phase_flowgraph``), YAML written to a
   temporary directory and run by ``run_flowgraph`` or the ``flowgraph``
   command, counts zeroed just before each: the off-grid route (the
   facade capture's three channels, the card's mixer bank; 18/18, the
   facade's dense frames, the file sink's bytes), the PFB-grid route (M =
   64 at 16 Msps, 8 channels; one ``pfb_fir`` launch a block), the EU868
   plan gateway on stream (c)'s capture (its frames), one channel on the
   parity and golden engines (equal frames), a message-only graph on
   127.0.0.1, ``blocks`` (12 descriptors) and ``analyze --max-buffers 2``;
15. sharding on the card (``phase_sharding``, ``lora_tpu_torch.parallel``),
   counts zeroed just before each part's gated call, then its median wall
   time over three calls: (a) channel sharding of the dense bench block
   over 4 shards of the card (512/512, the lanes of one call over the
   whole block); (b) time sharding of streaming (a)'s capture over 4
   shards (every packet exactly once, those across seams too); (c)
   wideband time sharding at M = 1024 over 4 shards of two halos each
   (64/64 exactly once); (d) subband sharding at 10,240 channels (8 x
   1280, SF6 implicit) over 8 shards, a packet on a central fine channel
   of each band (8/8), its K4 launches split by filterbank (8 coarse, 8
   fine); K4 at the coarse filterbank's shape (M = 8) and on the same
   planes at M = 4 and 1, each bit-equal to its plain version and timed
   beside ``conv1d(groups=M)`` with its tile (Tc, G, S, shared bytes), and
   its scalar instantiation at M = 1; (e) the group code
   path at world size 1: an NCCL group of one rank (its halo and exchange
   local copies, NCCL initialised and one ``all_reduce`` run) running
   (a)'s and (b)'s functions on a cut of their inputs, bit-equal to the
   one-shard in-process mesh;
16. each kernel's time beside its bound, its plain version's time and a
   library call's time where one computes the same function (the
   polyphase FIR at the wideband shape, float32 and bf16 out, and at the
   gateway's; the gateway's numbers also go into its ``kernels`` entry;
   the multi-lag kernel on the gateway's pitched view and at the US915
   plan's planes, whose numbers go into its entry's ``plan`` object; K1's
   launches a facade ``receive()`` go into its entry's ``facade`` object;
   K1, K3, K4 and K5 carry each graph's launches in a ``flowgraph``
   object; K1 and K4 their launches in each sharding part in a
   ``sharding`` object, and K4 its coarse-filterbank timing in a
   ``coarse`` object, M = 4 and 1 in ``coarse_m4`` and ``coarse_m1``).

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
# multi-lag rows: energies relative; each lag product absolute, times
# sqrt(e_r * e_{r+l}) (its Cauchy-Schwarz scale): float32 sums in another order
TOL_LAG_E_RTOL = 1e-5
TOL_LAG_Q = 1e-5
# fused plan channelizer: absolute, times sum|g2 row| * max|x|: twice the
# worst-case float32 rounding of a sum of 2DK products (the kernel's
# factored sums and the plain version's folded matmuls sum in other
# orders, with phasors rounded at other places), plus the ramp's four
# products
TOL_FUSED_ULPS = 2.0 ** -24
GATEWAY_SFS = (7, 8, 9, 10, 11, 12)
# bench.py --plan-gateway's geometries: (center Hz, sample rate)
PLAN_GEOMS = {"EU868": (868.0e6, 2e6), "US915": (903.0e6, 8e6)}
GATEWAY_LAGS = (1, 2, 4, 8, 16, 32)   # each SF's symbol in SF7 symbols
DEADBEEF = bytes.fromhex("deadbeef")


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


_START = time.perf_counter()


def stamp(what: str) -> None:
    """Print the seconds since the script started, after ``what``."""
    print(f"[{time.perf_counter() - _START:.1f} s] {what} done")


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


def _wrappers() -> dict:
    from lora_tpu_torch.ops import cuda_kernels as ck

    return {"det_metrics": ck.detection_metrics_kernel,
            "pfb_fir": ck.pfb_fir_kernel,
            "lag_rows": ck.lag_rows_kernel,
            "fused_chan": ck.fused_channelize_kernel,
            "det_tile": ck.detection_metrics_tile_kernel,
            "det_wm": ck.detection_metrics_wm_kernel}


def counts(names=("det_metrics", "pfb_fir", "lag_rows", "fused_chan")) -> dict:
    """The launch counts of the kernels ``names`` (the four receiver
    kernels by default; the study paths read theirs by name)."""
    w = _wrappers()
    return {n: w[n].launches for n in names}


def zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def phase_build():
    from lora_tpu_torch.ops._build import build

    t0 = time.perf_counter()
    built = build("det_metrics", "pfb_fir", "lag_rows", "fused_chan", "det_tile", "det_wm")
    print(f"build: {', '.join(built)} (one nvcc each, started together) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")


BENCH_METRICS = ("wideband_256ch_throughput", "wideband_1024ch_throughput",
                 "wideband_4096ch_throughput", "gateway_256ch_6sf_throughput",
                 "wideband_1024ch_full_occupancy_throughput",
                 "plan_gateway_eu868_6sf_throughput", "plan_gateway_us915_6sf_throughput",
                 "dense_rx_throughput_bf16", "dense_rx_throughput")


def bench_command(args, timeout: float) -> list:
    """``python -m *args`` from the repo root, in a session of its own that
    is killed whole at ``timeout`` s: its stderr and every JSON line it
    prints are printed; it must exit 0. Returns its JSON lines."""
    import os
    import signal
    from pathlib import Path

    label = " ".join(args)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    for line in err.splitlines():
        print(f"  {label}: {line}")
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for rec in lines:
        print(f"bench: {json.dumps(rec)}")
    print(f"{label}: exit code {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, f"{label}: exit code {proc.returncode}")
    for rec in lines:
        check(rec.get("decode_ratio", 1.0) == 1.0 and rec.get("n_dropped", 0) == 0,
              f"{label}: {rec}")
    return lines


def phase_bench() -> None:
    """The bench command, every stage, then ``cli bench`` (its dense
    stage at 64 channels): the metric names once each, in ``bench.py``'s
    order."""
    names = [r["metric"] for r in bench_command(["lora_tpu_torch.bench"], 600)]
    check(names == list(BENCH_METRICS), f"bench: metrics {names}")
    names = [r["metric"] for r in bench_command(["lora_tpu_torch.cli", "bench"], 120)]
    check(names == list(BENCH_METRICS[-2:]), f"cli bench: metrics {names}")


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


def phase_pfb_vs_plain() -> float:
    """K4 against its plain version on the card: bit-equal (every dtype
    pair) at every checked geometry, through the vector instantiation
    where ``_pfb_vector_width`` allows it and the scalar one where the
    plane stride or M does not. Returns the largest absolute difference of
    the float32 outputs (0 when it passes)."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (_pfb_vector_width, pfb_fir_kernel,
                                                 pfb_fir_planes)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    # (M, n_vec, K, tail samples past n_vec * M, plane stride one sample
    # longer than L, dtype pairs): the wideband bench at M = 1024 and
    # 4096; the gateway (float32 in, bf16 out); M = 8 and 1000 (ragged
    # branch tiles); n_vec off the step grid; K = 1 and 16; K = 37 (six
    # tap passes); n_vec = K (one output row); then the scalar
    # instantiation: L not a multiple of 4 samples, M = 1001 and 6, an odd
    # plane stride; then the narrow tile (M = 1, 2, 4, 8, 16 at the coarse
    # filterbank's K = 13, n_vec off its step grid; M = 8 on it; n_vec = K
    # at M = 8 and 1; an odd plane stride at M = 8) and M = 124 (31 chunks
    # of 4: a ragged 32-thread tile)
    f32_in = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16))
    both = f32_in + ((torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16))
    geoms = [(1024, 24576, 10, 0, False, both), (4096, 24576, 10, 0, False, f32_in),
             (256, 450560, 10, 0, False, ((torch.float32, torch.bfloat16),)),
             (8, 4000, 10, 0, False, f32_in), (1000, 517, 10, 0, False, both),
             (128, 533, 10, 0, False, f32_in), (256, 300, 1, 0, False, f32_in),
             (256, 300, 16, 0, False, f32_in), (64, 400, 37, 0, False, both),
             (512, 10, 10, 0, False, f32_in), (1024, 200, 10, 333, False, both),
             (1001, 300, 10, 0, False, both), (6, 5000, 10, 0, False, both),
             (256, 400, 10, 0, True, both), (1, 90001, 13, 0, False, both),
             (2, 40001, 13, 0, False, both), (4, 20001, 13, 0, False, both),
             (8, 10001, 13, 0, False, both), (8, 256 * 40 + 12, 13, 0, False, both),
             (16, 5001, 13, 0, False, both), (8, 13, 13, 0, False, both),
             (1, 13, 13, 0, False, both), (8, 3001, 13, 0, True, both),
             (124, 2000, 10, 0, False, both)]
    worst = 0.0
    for M, n_vec, K, tail, odd, pairs in geoms:
        L = n_vec * M + tail
        x32 = torch.randn((2, L + odd), generator=gen, device="cuda")
        h = 0.1 * torch.randn((K, M), generator=gen, device="cuda")
        for in_dtype, out in pairs:
            x = x32.to(in_dtype)[:, :L]
            vec = _pfb_vector_width(x, h, torch.empty(0, dtype=out, device="cuda"))
            before = pfb_fir_kernel.launches
            got = pfb_fir_kernel(x, h, out)
            torch.cuda.synchronize()
            check(pfb_fir_kernel.launches == before + 1, "the pfb_fir launch count did not rise")
            ref = pfb_fir_planes(x, h, out)
            shape = (2, n_vec - K + 1, M)
            check(tuple(got.shape) == shape and got.dtype == out,
                  f"pfb_fir: {tuple(got.shape)} {got.dtype}, expected {shape} {out}")
            check(bool(torch.isfinite(got).all()), "pfb_fir: non-finite output")
            err = float((got.float() - ref.float()).abs().max())
            label = (f"pfb_fir {str(in_dtype)[6:]}->{str(out)[6:]} M={M} n_vec={n_vec} K={K} "
                     f"tail={tail} plane stride {x.stride(0)}, {vec} branches a thread")
            print(f"{label}: max abs err {err:.3g} (must be 0: bit-equal)")
            check(err == 0 and torch.equal(got, ref), f"{label}: not bit-equal, error {err}")
            if out == torch.float32:
                worst = max(worst, err)
            del got, ref, x
        del x32
    torch.cuda.empty_cache()
    return worst


def lag_rows_errors(got, ref, lags):
    """Largest absolute error of the kernel's rows, the largest energy
    error relative to the energy, and the largest lag-product error over
    its Cauchy-Schwarz scale ``sqrt(e_r * e_{r+l})``."""
    import torch

    (e_g, q_g), (e_r, q_r) = got, ref
    err_abs = float((e_g - e_r).abs().max())
    err_e = float(((e_g - e_r).abs() / e_r.abs().clamp(min=1e-30)).max())
    err_q = 0.0
    for lag in lags:
        nxt = torch.nn.functional.pad(e_r, (0, lag))[..., lag:lag + e_r.shape[-1]]
        scale = torch.sqrt(e_r * nxt).clamp(min=1e-30)
        for g, r in zip(q_g[lag], q_r[lag]):
            d = (g - r).abs()
            err_abs = max(err_abs, float(d.max()))
            err_q = max(err_q, float((d / scale).max()))
    return err_abs, err_e, err_q


def lag_bound(shape, itemsize: int, sps: int, lags):
    """``(bound ms, bytes ms, ops ms, "bytes" | "operations")`` of K3 over
    planes of ``shape`` ``[C, 2, L]``: the planes read once and the rows
    written once; 4 float32 flops a complex sample for the energy and 8
    for each lag's product where the partner row exists."""
    C, _, L = shape
    R = L // sps
    t_bytes = (C * 2 * L * itemsize + C * (1 + 2 * len(lags)) * R * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (4 * C * R * sps + sum(8 * C * max(R - m, 0) * sps for m in lags)) \
        / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, "bytes" if t_bytes >= t_ops else "operations"


def lag_copies(xf, sps: int, lags) -> str:
    """Which instantiation of K3 the wrapper launches on ``xf``."""
    from lora_tpu_torch.ops.cuda_kernels import _lag_vector_width

    width = _lag_vector_width(xf, sps)
    return (f"{'16-byte' if width > 1 else 'scalar'} copies"
            + (", partners past the ring from memory" if max(lags) > 32 else ""))


def phase_lag_vs_plain() -> float:
    """K3 against its plain version on the card, float32 and bf16, on
    contiguous and pitched planes, through both instantiations. Returns
    the largest absolute error of any output."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import lag_rows_kernel, lag_rows_planes
    from lora_tpu_torch.rx.frontend import detection_metrics_planes, metrics_from_lag_rows

    gen = torch.Generator(device="cuda").manual_seed(777)
    # (C, sps_min, rows, tail samples, lags, plane pitch past L): the
    # gateway's planes as the channelizer's view gives them (pitch 450,552)
    # and as a contiguous copy, and the US915 and EU868 plan gateways' (23
    # and 7 channels); SF7-12 at 1 Msps with a ragged row count, contiguous
    # and with a pitch off the 16-byte grid; a lag set that is not powers
    # of two; sps off the 128 grid (100, 1000); lags at and past R; one run
    # of rows, and one ragged past a run; lags past the staged rows (read
    # from memory), contiguous and pitched; twelve lags (two groups); sps =
    # 4096 (16 column chunks), pitched and contiguous
    geoms = [(256, 256, 1759, 247, GATEWAY_LAGS, 1), (256, 256, 1759, 247, GATEWAY_LAGS, 0),
             (23, 256, 1759, 247, GATEWAY_LAGS, 0), (7, 256, 1759, 247, GATEWAY_LAGS, 0),
             (3, 128, 37 * 32 + 5, 17, GATEWAY_LAGS, 0),
             (3, 128, 37 * 32 + 5, 17, GATEWAY_LAGS, 3),
             (3, 128, 111, 17, (1, 3), 0), (2, 100, 300, 0, (1, 2, 4), 0),
             (2, 1000, 50, 7, (1, 2, 4, 8), 0), (2, 256, 20, 0, (1, 2, 20, 64), 0),
             (1, 128, 20, 0, GATEWAY_LAGS, 0), (1, 128, 40, 0, GATEWAY_LAGS, 0),
             (2, 128, 150, 5, (1, 5, 70, 100), 0), (2, 128, 150, 0, (1, 5, 70, 100), 8),
             (2, 64, 50, 0, tuple(range(1, 13)), 0), (2, 4096, 40, 0, (1, 2, 4), 8),
             (2, 4096, 40, 5, (1, 2, 4), 0)]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for C, sps, rows, tail, lags, pad in geoms:
            n = rows * sps + tail
            xf = torch.randn((C, 2, n + pad), generator=gen, device="cuda").to(dtype)[..., :n]
            before = lag_rows_kernel.launches
            got = lag_rows_kernel(xf, sps, lags)
            torch.cuda.synchronize()
            check(lag_rows_kernel.launches == before + 1, "the lag_rows launch count did not rise")
            again = lag_rows_kernel(xf, sps, lags)
            check(torch.equal(got[0], again[0])
                  and all(torch.equal(a, b) for m in lags for a, b in zip(got[1][m], again[1][m])),
                  "lag_rows: two launches on the same input differ")
            del again
            ref = lag_rows_planes(xf, sps, lags)
            outs = [got[0]] + [q for lag in lags for q in got[1][lag]]
            for g in outs:
                check(tuple(g.shape) == (C, rows) and g.dtype == torch.float32,
                      f"lag_rows: {tuple(g.shape)} {g.dtype}, expected {(C, rows)} float32")
                check(bool(torch.isfinite(g).all()), "lag_rows: non-finite output")
            err_abs, err_e, err_q = lag_rows_errors(got, ref, lags)
            label = (f"lag_rows {str(dtype)[6:]} C={C} sps={sps} R={rows} tail={tail} "
                     f"lags={lags} plane stride {xf.stride(1)} ({lag_copies(xf, sps, lags)})")
            msg = (f"{label}: max abs err {err_abs:.3g}, energy max rel err {err_e:.3g}, "
                   f"lag product max err / sqrt(e e) {err_q:.3g}, a second launch bit-identical")
            if rows == 1759:   # the gateways: each SF's metrics from the rows, against K1's plain version
                err_c = 0.0
                for m in lags:
                    corr, e1, e2 = metrics_from_lag_rows(got[0], *got[1][m], m)
                    want = detection_metrics_planes(xf, m * sps)
                    err_c = max(err_c, float((corr - want[0]).abs().max()))
                    for a, b in ((e1, want[1]), (e2, want[2])):
                        rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                        check(rel <= TOL_ENER_RTOL, f"{label}: SF energy error {rel}")
                msg += f"; per-SF corr max abs err {err_c:.3g}"
                check(err_c <= TOL_CORR_ATOL, f"{label}: per-SF corr error {err_c}")
            print(msg)
            check(err_e <= TOL_LAG_E_RTOL, f"{label}: energy error {err_e} > {TOL_LAG_E_RTOL}")
            check(err_q <= TOL_LAG_Q, f"{label}: lag product error {err_q} > {TOL_LAG_Q}")
            worst = max(worst, err_abs)
            del xf, got, ref
    torch.cuda.empty_cache()
    return worst


def fused_min_ops(C: int, D: int, n_taps: int, n_out: int) -> int:
    """float32 operations the fused channelizer's function needs at least:
    each channel mixes each input sample once (a complex product, 6 flops;
    D samples an output), then applies the real taps to the mixed samples
    (a real-by-complex multiply-add, 4 flops a tap and output). The
    phasors' own cost and the zero-padded taps are not counted."""
    return C * n_out * (6 * D + 4 * n_taps)


def fused_kernel_ops(C: int, D: int, n_taps: int, n_out: int) -> int:
    """float32 operations the CUDA kernel (``csrc/fused_chan.cu``) issues,
    an FMA counted as 2 (its factored form): the mix forms ``rho * phi``
    and then ``x * (rho * phi)``, 8 FMA-pipe instructions a staged sample
    and channel, over ``kT + J - 1`` staged rows a block of ``kT = 256``
    outputs for each pass of ``J`` tap rows; the taps are ``2 D J`` FMAs a
    channel, output and pass (the passes' padded rows included). Blocks
    count whole; channel slots past ``C`` do not."""
    K = -(-n_taps // D)
    passes = -(-K // 16)
    J = -(-K // passes)
    tiles = -(-n_out // 256)
    mix = 8 * D * (256 + J - 1) * passes * tiles
    taps = 2 * D * J * passes * 256 * tiles
    return 2 * C * (mix + taps)


def phase_fused_vs_plain() -> float:
    """K5 against its plain version on the card, float32. Returns the
    largest absolute error."""
    import numpy as np
    import torch

    from lora_tpu_torch.channelizer import firdes_low_pass, fused_tables
    from lora_tpu_torch.ops.cuda_kernels import fused_channelize_kernel, fused_channelize_planes

    gen = torch.Generator(device="cuda").manual_seed(2468)
    # (C, D, taps, L): the EU868 and US915 plan shapes (their own taps);
    # a ragged L; C = 1; D = 2; D = 1 (two passes of 16 tap rows); past the
    # TPU kernel's gate (K = 151: ten passes; 2DK = 2016 with 63 tap rows:
    # four); C = 9 (two channel groups) at D = 3
    geoms = [(7, 8, 77, 3604480), (23, 32, 309, 14417920), (7, 8, 77, 100003),
             (1, 4, 19, 4429), (3, 2, 9, 2100), (2, 1, 31, 3000), (2, 2, 301, 5000),
             (3, 16, 1001, 40000), (9, 3, 20, 7777)]
    worst = 0.0
    for C, D, nt, L in geoms:
        rate = D * 250e3
        offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
        if (C, D, nt) in ((7, 8, 77), (23, 32, 309)):
            taps = firdes_low_pass(1.0, rate, 77.5e3, 62.5e3)
            check(len(taps) == nt, f"plan taps {len(taps)} != {nt}")
        else:
            taps = np.random.default_rng(C * 100 + D).normal(0, 0.1, nt).astype(np.float32)
        g2, ramp, mix = fused_tables(offs, rate, taps, D, L, "cuda")
        x = torch.randn((2, L), generator=gen, device="cuda")
        before = fused_channelize_kernel.launches
        got = fused_channelize_kernel(x, g2, ramp, D, nt, mix)
        torch.cuda.synchronize()
        check(fused_channelize_kernel.launches == before + 1,
              "the fused_chan launch count did not rise")
        ref = fused_channelize_planes(x, g2, ramp, D, nt, 1024)
        shape = (C, 2, (L - nt) // D + 1)
        check(tuple(got.shape) == shape and got.dtype == torch.float32 and got.is_contiguous(),
              f"fused_chan: {tuple(got.shape)} {got.dtype}, expected {shape} float32")
        check(bool(torch.isfinite(got).all()), "fused_chan: non-finite output")
        scale = float(g2.abs().sum(1).max()) * float(x.abs().max())
        tol = 2 * (g2.shape[1] + 4) * TOL_FUSED_ULPS * scale
        err = float((got - ref).abs().max())
        label = f"fused_chan C={C} D={D} taps={nt} K={-(-nt // D)} L={L}"
        print(f"{label}: max abs err {err:.3g} ({err / scale:.3g} of sum|g2 row| * max|x|; "
              f"tolerance {tol:.3g})")
        check(err <= tol, f"{label}: error {err} > {tol}")
        worst = max(worst, err)
        del x, got, ref
    torch.cuda.empty_cache()
    return worst


def phase_variants_vs_plain() -> dict:
    """K2 (the "tile" variant) against ``detection_metrics_planes`` and K6
    against ``detection_metrics_wm_planes`` on the card, at K1's shapes:
    sps 1024 / 8192 / 32768, a ragged window count with a tail, sps off the
    128 grid, an odd sps (scalar loads) and the dense bench block; K2 also
    on bfloat16 planes (upcast to float32 first), K6 also at window counts
    that are a multiple of no tile (its planes are the float32 planes in
    window-major form, made on the card). Tolerances as K1's. Returns the
    largest corr error of each."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes,
                                                 detection_metrics_tile_kernel,
                                                 detection_metrics_wm_kernel,
                                                 detection_metrics_wm_planes)

    gen = torch.Generator(device="cuda").manual_seed(5678)
    geoms = [(64, 1024, 2048, 0), (2, 8192, 16, 0), (2, 32768, 8, 0), (3, 1024, 37, 341),
             (2, 1000, 40, 0), (2, 1001, 9, 5)]
    worst = {"det_tile": 0.0, "det_wm": 0.0}

    def held(name, label, got, ref, shape):
        for g in got:
            check(tuple(g.shape) == shape and g.dtype == torch.float32,
                  f"{label}: {tuple(g.shape)} {g.dtype}, expected {shape} float32")
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
        err_c = float((got[0] - ref[0]).abs().max())
        err_e = max(float(((g - r).abs() / r.abs()).max()) for g, r in zip(got[1:], ref[1:]))
        print(f"{label}: corr max abs err {err_c:.3g}, energy max rel err {err_e:.3g}")
        check(err_c <= TOL_CORR_ATOL, f"{label}: corr error {err_c} > {TOL_CORR_ATOL}")
        check(err_e <= TOL_ENER_RTOL, f"{label}: energy error {err_e} > {TOL_ENER_RTOL}")
        worst[name] = max(worst[name], err_c)

    for dtype in (torch.float32, torch.bfloat16):
        for C, sps, k1, tail in geoms:
            xf = torch.randn((C, 2, k1 * sps + tail), generator=gen, device="cuda").to(dtype)
            before = detection_metrics_tile_kernel.launches
            got = detection_metrics_kernel(xf, sps, variant="tile")
            torch.cuda.synchronize()
            check(detection_metrics_tile_kernel.launches == before + 1,
                  "the det_tile launch count did not rise")
            held("det_tile", f"det_tile {str(dtype)[6:]} C={C} sps={sps} K1={k1} tail={tail}",
                 got, detection_metrics_planes(xf, sps), (C, k1 - 1))
            del xf, got
    for C, sps, k1 in [(g[0], g[1], g[2]) for g in geoms] + [(3, 128, 1031), (2, 256, 4099)]:
        xw = torch.randn((C, k1, 2, sps), generator=gen, device="cuda")
        before = detection_metrics_wm_kernel.launches
        got = detection_metrics_wm_kernel(xw)
        torch.cuda.synchronize()
        check(detection_metrics_wm_kernel.launches == before + 1,
              "the det_wm launch count did not rise")
        ref = detection_metrics_wm_planes(xw)
        held("det_wm", f"det_wm float32 C={C} K1={k1} sps={sps}", got, ref, (C, k1))
        last = got[0][:, -1]
        check(bool(((last - 1.0).abs() <= TOL_CORR_ATOL).all()),
              "det_wm: the last window does not pair with itself")
        del xw, got, ref
    torch.cuda.empty_cache()
    print(f"det_tile / det_wm worst corr error over the shapes: {worst['det_tile']:.3g} / "
          f"{worst['det_wm']:.3g} (tolerance {TOL_CORR_ATOL})")
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
    from lora_tpu_torch.ops.xfer import pack_iq

    rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24, sfd_search=12,
                       demod_method="fft")
    check(rx.device.type == "cuda", "the receiver did not default to the card")
    planes = {}
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = pack_iq(x, dtype=dtype)
        torch.cuda.synchronize()
        zero_counts()
        res = rx.process(xd)
        torch.cuda.synchronize()
        launches[dtype] = counts()
        label = str(dtype)[6:]
        check(launches[dtype]["det_metrics"] > 0,
              f"{label}: the main path did not launch det_metrics")
        print(f"main path {label}: launches {launches[dtype]}")
        check(tuple(res.valid.shape) == (x.shape[0], rx.P), "result shape")
        gate(res, expected, label)
        planes[dtype] = xd
    return rx, planes, launches


def phase_run_small(cfg, x, pkt_len, method: str = "fft"):
    """``run()`` on a small block of whole packets, on the card and on the
    CPU, with the ``method`` engine: the frames must agree field by field
    (the CPU runs the plain version of every kernel)."""
    from lora_tpu_torch import DenseReceiver

    small = x[:2, : 2 * pkt_len + 997]
    frames = {}
    for dev in ("cuda", "cpu"):
        rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24,
                           sfd_search=12, demod_method=method, device=dev)
        frames[dev] = rx.run(small)
    label = "run()" if method == "fft" else f"run() {method}"
    check(len(frames["cuda"]) > 0, f"{label}: no frames")
    same_frames(frames["cuda"], frames["cpu"], label)
    print(f"{label}: {len(frames['cuda'])} frames on a 2-channel block, equal to the CPU's")


def same_frames(fg, fc, label: str) -> None:
    check(len(fg) == len(fc), f"{label}: {len(fg)} frames on the card, {len(fc)} on the CPU")
    for a, b in zip(fg, fc):
        check(a.payload[:4] == DEADBEEF, f"{label}: wrong payload")
        check(a.crc_ok is True, f"{label}: MAC CRC fails")
        check((a.phy_header.to_bytes(), a.payload, a.channel, a.sample_index,
               a.tap_header.frequency)
              == (b.phy_header.to_bytes(), b.payload, b.channel, b.sample_index,
                  b.tap_header.frequency),
              f"{label}: frame differs from the CPU's")
        check(abs(a.cfo - b.cfo) <= 1.0, f"{label}: cfo differs from the CPU's")
        check(abs(a.snr - b.snr) <= 1e-4 * abs(b.snr), f"{label}: snr differs")


def wideband_capture(M: int, active, seed: int = 0):
    """``bench.py``'s wideband capture, built on the card: SF7 CR4/8
    channels at 250 ksps, ``L = M * 96 * 256`` wideband samples of
    complex noise (sigma 1e-3 a part, a seeded ``torch.Generator``), and
    one ``deadbeef`` packet from the port's modulator on each active
    channel, upconverted to the channel's frequency with a float64
    carrier phase (reduced mod 1 cycle) at ``bench.py``'s offsets.
    Returns ``(chan_config, planes [2, L] float32)``."""
    import math

    import torch

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.channelizer import pfb_channel_freqs
    from lora_tpu_torch.tx.modulator import modulate_frame

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    wide_cfg = LoRaConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    L = M * 96 * cfg.samples_per_symbol
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.view_as_complex(1e-3 * torch.randn((L, 2), generator=gen, device="cuda"))
    pkt = torch.from_numpy(modulate_frame(wide_cfg, DEADBEEF, snr_db=None)).to("cuda")
    pkt = pkt.to(torch.complex128)
    n = pkt.shape[0]
    t = torch.arange(n, dtype=torch.float64, device="cuda")
    freqs = pfb_channel_freqs(wide_rate, M)
    for c in active:
        pos = min((8 + (c % 7)) * cfg.samples_per_symbol * M // 8, L - n - 1)
        cycles = torch.remainder((t + pos) * (freqs[c] / wide_rate), 1.0)
        carrier = torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
        x[pos:pos + n] += (pkt * carrier).to(torch.complex64)
    return cfg, torch.stack([x.real, x.imag]).contiguous()


def wideband_gate(res, active, label: str, no_drops: bool = False) -> None:
    """Every active channel gives ``de ad be ef``, no valid lane gives a
    wrong payload, and (``no_drops``) no candidate was dropped."""
    valid = res.valid.cpu().numpy()
    chan = res.channel.cpu().numpy()[valid]
    pay = res.payload.cpu().numpy()[valid]
    plen = res.length.cpu().numpy()[valid]
    good = (pay[:, :4] == list(DEADBEEF)).all(axis=-1) & (plen >= 4)
    got = {int(c) for c in chan[good]}
    bad = int((~good).sum())
    n_dropped = int(res.n_dropped)
    for name in ("snr", "cfo"):
        check(bool(getattr(res, name)[res.valid].isfinite().all()),
              f"{label}: non-finite {name}")
    print(f"wideband {label}: {len(got & set(active))}/{len(active)} channels give "
          f"de ad be ef, {int(valid.sum())} valid lanes, {bad} wrong payloads, "
          f"n_dropped {n_dropped}")
    check(got == set(active), f"{label}: channels {sorted(set(active) - got)[:8]} missing, "
          f"{sorted(got - set(active))[:8]} unexpected")
    check(bad == 0, f"{label}: {bad} wrong payloads")
    if no_drops:
        check(n_dropped == 0, f"{label}: n_dropped {n_dropped}")


def run_wideband(wr, xd, label: str):
    """One ``process()`` call with every count zeroed just before it and
    read just after; the path must launch K4 and K1 once each."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    res = wr.process(xd)
    torch.cuda.synchronize()
    n = counts()
    print(f"wideband {label}: launches {n}")
    check(n == {"det_metrics": 1, "pfb_fir": 1, "lag_rows": 0, "fused_chan": 0},
          f"{label}: expected one det_metrics and one pfb_fir launch, got {n}")
    return res, n


def phase_wideband():
    """The wideband path at full width: ``bench.py --wideband 1024`` in
    float32 and bf16 planes, ``--wideband-full 1024`` and ``--wideband
    4096``. Returns the M = 1024 receivers and capture for the later
    phases, and the float32 call's launch counts."""
    import torch

    from lora_tpu_torch import WidebandReceiver

    kw = dict(max_candidates=2, max_symbols=24, sfd_search=12, demod_method="fft")
    M = 1024
    active = list(range(0, M, 16))
    cfg, xd = wideband_capture(M, active)
    receivers, launches = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        wr = WidebandReceiver(cfg, M, pool=2 * len(active), plane_dtype=dtype, **kw)
        check(wr.device.type == "cuda", "the wideband receiver did not default to the card")
        label = f"M={M} {str(dtype)[6:]} pool={wr.pool}"
        res, launches[dtype] = run_wideband(wr, xd, label)
        check(tuple(res.valid.shape) == (wr.pool,), f"{label}: result shape")
        wideband_gate(res, active, label)
        receivers[dtype] = wr

    full = list(range(M))
    _, xfull = wideband_capture(M, full, seed=1)
    wr = WidebandReceiver(cfg, M, pool=M + M // 8, plane_dtype=torch.bfloat16, **kw)
    label = f"M={M} full occupancy bfloat16 pool={wr.pool}"
    res, _ = run_wideband(wr, xfull, label)
    wideband_gate(res, full, label, no_drops=True)
    del xfull, wr, res

    M4 = 4096
    active4 = list(range(0, M4, M4 // 64))
    cfg4, x4 = wideband_capture(M4, active4, seed=2)
    wr = WidebandReceiver(cfg4, M4, pool=2 * len(active4), plane_dtype=torch.bfloat16, **kw)
    check(wr.pfb._two_stage_split(M4, 2048) == (64, 64), "M=4096 must take the 64 x 64 split")
    label = f"M={M4} two-stage DFT bfloat16 pool={wr.pool}"
    res, _ = run_wideband(wr, x4, label)
    wideband_gate(res, active4, label)
    del x4, wr, res
    torch.cuda.empty_cache()
    return receivers, xd, launches


def phase_wideband_run_small():
    """``run()`` on a small wideband capture (M = 8, three packets, host
    numpy), pooled and per-channel, on the card and on the CPU: the frames
    must agree field by field."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig, WidebandReceiver
    from lora_tpu_torch.channelizer import pfb_channel_freqs
    from lora_tpu_torch.tx.modulator import modulate_frame

    M = 8
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    wide_cfg = LoRaConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    sps_w = wide_cfg.samples_per_symbol
    rng = np.random.default_rng(5)
    x = 1e-3 * (rng.normal(size=(160 * sps_w, 2)) @ [1, 1j])
    freqs = pfb_channel_freqs(wide_rate, M)
    for c in (1, 3, 6):
        pkt = modulate_frame(wide_cfg, DEADBEEF + bytes([c]), snr_db=None)
        pos = (8 + 3 * c) * sps_w
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[c] / wide_rate * t)
    x = x.astype(np.complex64)
    for pool in (None, 8):
        frames = {dev: WidebandReceiver(cfg, M, pool=pool, max_candidates=2, max_symbols=24,
                                        sfd_search=12, demod_method="fft", device=dev).run(x)
                  for dev in ("cuda", "cpu")}
        check(sorted(f.channel for f in frames["cuda"]) == [1, 3, 6],
              f"wideband run() pool={pool}: channels {[f.channel for f in frames['cuda']]}")
        same_frames(frames["cuda"], frames["cpu"], f"wideband run() pool={pool}")
    print("wideband run(): 3 frames on an 8-channel capture, pooled and per-channel, "
          "equal to the CPU's")


def gateway_capture(M: int, max_pkt_samples: int, seed: int = 3):
    """``bench.py --gateway``'s capture (``bench.py:94-180``), built on the
    card: channels of CR4/8 at 250 ksps, ``L = M * (max_pkt_samples + 6 *
    8192)`` wideband samples (the largest SF's packet region and six of its
    symbols) of complex noise (sigma 1e-3 a part, a seeded
    ``torch.Generator``), and one ``deadbeef`` packet on every
    ``M // 24``-th channel, SFs 7-12 round-robin, each starting two
    symbols of its own SF in. Each SF's packet is modulated once (the
    port's modulator, at the wideband rate) and upconverted to each of its
    channels with a float64 carrier phase reduced mod 1 cycle. Returns
    ``(planes [2, L] float32, {(sf, channel)})``."""
    import math

    import torch

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.channelizer import pfb_channel_freqs
    from lora_tpu_torch.tx.modulator import modulate_frame

    wide_rate = M * 250e3
    L = M * (max_pkt_samples + 6 * 8192)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.view_as_complex(1e-3 * torch.randn((L, 2), generator=gen, device="cuda"))
    freqs = pfb_channel_freqs(wide_rate, M)
    active = list(range(0, M, max(1, M // 24)))
    expect = set()
    for k, sf in enumerate(GATEWAY_SFS):
        chans = active[k::len(GATEWAY_SFS)]
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=wide_rate, crc=True)
        pkt = torch.from_numpy(modulate_frame(wcfg, DEADBEEF, snr_db=None)).to("cuda")
        pkt = pkt.to(torch.complex128)
        n = pkt.shape[0]
        pos = 2 * wcfg.samples_per_symbol
        check(pos + n <= L, f"SF{sf}: the packet does not fit the capture")
        t = torch.arange(pos, pos + n, dtype=torch.float64, device="cuda")
        for c in chans:
            cycles = torch.remainder(t * (freqs[c] / wide_rate), 1.0)
            x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
                               ).to(torch.complex64)
            expect.add((sf, c))
    return torch.stack([x.real, x.imag]).contiguous(), expect


def gateway_gate(results, expect, label: str) -> dict:
    """Every placement gives ``de ad be ef`` at its own SF and no valid
    lane of any SF gives a wrong payload or decodes where no packet of its
    SF was sent. Returns ``{sf: (valid, channel, start, payload)}`` on the
    host, for comparing two runs."""
    got, bad, lanes = set(), 0, {}
    for sf, res in results.items():
        valid = res.valid.cpu().numpy()
        chan = res.channel.cpu().numpy()[valid]
        pay = res.payload.cpu().numpy()[valid]
        plen = res.length.cpu().numpy()[valid]
        good = (pay[:, :4] == list(DEADBEEF)).all(axis=-1) & (plen >= 4)
        for c, ok in zip(chan, good):
            if ok and (sf, int(c)) in expect:
                got.add((sf, int(c)))
            else:
                bad += 1
        for name in ("snr", "cfo"):
            check(bool(getattr(res, name)[res.valid].isfinite().all()),
                  f"{label} SF{sf}: non-finite {name}")
        lanes[sf] = tuple(getattr(res, f).cpu().numpy()
                          for f in ("valid", "channel", "start", "payload"))
        print(f"gateway {label} SF{sf}: {int(valid.sum())} valid lanes, "
              f"{len({c for s, c in got if s == sf})}/{len({c for s, c in expect if s == sf})} "
              f"placements, n_dropped {int(res.n_dropped)}")
    print(f"gateway {label}: {len(got)}/{len(expect)} placements decode de ad be ef at "
          f"their own SF, {bad} wrong or misplaced lanes")
    check(got == expect, f"{label}: placements {sorted(expect - got)[:8]} missing")
    check(bad == 0, f"{label}: {bad} wrong or misplaced lanes")
    return lanes


def run_gateway(gw, xd, label: str, want: dict):
    """One ``process()`` call with every count zeroed just before it and
    read just after; it must launch exactly the kernels of ``want``."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    res = gw.process(xd)
    torch.cuda.synchronize()
    n = counts()
    print(f"gateway {label}: launches {n}")
    check(n == want, f"{label}: expected launches {want}, got {n}")
    return res, n


def phase_gateway():
    """The gateway path at full width: ``bench.py --gateway 256`` with the
    shared detection, then the per-SF detection on the same capture,
    which must decode the same lanes. Returns the receiver, its capture
    and the shared call's launch counts."""
    import numpy as np
    import torch

    from lora_tpu_torch import LoRaConfig, MultiSFWidebandReceiver

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    gw = MultiSFWidebandReceiver(cfg, 256, sfs=GATEWAY_SFS, pool=48, max_candidates=2,
                                 max_symbols=24, sfd_search=12, demod_method="fft",
                                 plane_dtype=torch.bfloat16)
    check(gw.device.type == "cuda", "the gateway did not default to the card")
    xd, expect = gateway_capture(gw.M, gw.max_pkt_samples)
    check(xd.shape[-1] == 115_343_360, f"gateway capture length {xd.shape[-1]}")
    check(all(not gw.rxs[sf].fft_drift_pass for sf in (7, 8, 9, 10))
          and gw.rxs[11].fft_drift_pass and gw.rxs[12].fft_drift_pass
          and gw.rxs[12]._fold_mat is None and gw.rxs[11]._fold_mat is not None,
          "the gateway's SF receivers: drift pass from SF11, no fold matrices at SF12")
    res, launches = run_gateway(gw, xd, "shared detection",
                                {"det_metrics": 0, "pfb_fir": 1, "lag_rows": 1,
                                 "fused_chan": 0})
    check(sorted(res) == list(GATEWAY_SFS), f"gateway result keys {sorted(res)}")
    shared = gateway_gate(res, expect, "shared detection")
    gw.shared_detection = False
    res, _ = run_gateway(gw, xd, "per-SF detection",
                         {"det_metrics": len(GATEWAY_SFS), "pfb_fir": 1, "lag_rows": 0,
                          "fused_chan": 0})
    per_sf = gateway_gate(res, expect, "per-SF detection")
    gw.shared_detection = True
    for sf in GATEWAY_SFS:
        check(all(np.array_equal(a, b) for a, b in zip(shared[sf], per_sf[sf])),
              f"SF{sf}: the per-SF detection decoded other lanes than the shared one")
    print("gateway: the per-SF detection decodes the same lanes as the shared one")
    del res
    return gw, xd, launches


def phase_gateway_run_small():
    """``run()`` on a small gateway capture (tests/test_multi_sf.py:42-69:
    M = 8, SF7-9, one packet at each), on the card and on the CPU: the
    frames must agree field by field."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig, MultiSFWidebandReceiver
    from lora_tpu_torch.channelizer import pfb_channel_freqs
    from lora_tpu_torch.tx.modulator import modulate_frame

    M = 8
    cfg = LoRaConfig(sf=7, cr=1, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    freqs = pfb_channel_freqs(wide_rate, M)
    placements = [(7, 2), (8, 5), (9, 6)]
    kw = dict(sfs=(7, 8, 9), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
              demod_method="fft")
    gws = {dev: MultiSFWidebandReceiver(cfg, M, device=dev, **kw) for dev in ("cuda", "cpu")}
    sps9 = 4 * cfg.samples_per_symbol
    L = (32 * sps9 + 2 * gws["cpu"].max_pkt_samples) * M
    rng = np.random.default_rng(7)
    x = 1e-4 * (rng.normal(size=(L, 2)) @ [1, 1j])
    for sf, c in placements:
        wcfg = LoRaConfig(sf=sf, cr=1, samp_rate=wide_rate, crc=True)
        pkt = modulate_frame(wcfg, DEADBEEF + bytes([c]), snr_db=None)
        pos = 2 * wcfg.samples_per_symbol
        t = np.arange(pos, pos + len(pkt))
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[c] / wide_rate * t)
    x = x.astype(np.complex64)
    frames = {dev: gw.run(x) for dev, gw in gws.items()}
    check(sorted((f.tap_header.sf, f.channel) for f in frames["cuda"]) == placements,
          f"gateway run(): {[(f.tap_header.sf, f.channel) for f in frames['cuda']]}")
    same_frames(frames["cuda"], frames["cpu"], "gateway run()")
    check([f.tap_header.sf for f in frames["cuda"]] == [f.tap_header.sf for f in frames["cpu"]],
          "gateway run(): SFs differ from the CPU's")
    print("gateway run(): 3 frames at SF7, 8 and 9 on an 8-channel capture, equal to the CPU's")


def plan_capture(gw, seed: int = 4):
    """``bench.py --plan-gateway``'s capture (``bench.py:195-228``), built on
    the card: ``L = decim * (max_pkt_samples + 6 * max_sps)`` wideband
    samples of complex noise (sigma 1e-3 a part, a seeded
    ``torch.Generator``) and one ``deadbeef`` packet on every in-band plan
    channel, SFs 7-12 round-robin, each starting two symbols of its own SF
    in. Each SF's packet is modulated once (the port's modulator, at the
    wideband rate) and upconverted to its channel's offset with a float64
    carrier phase reduced mod 1 cycle. Returns ``(planes [2, L] float32,
    {(sf, channel)})``."""
    import math

    import torch

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    rate = gw.samp_rate
    max_sps = max(rx.sps for rx in gw.rxs.values())
    L = gw.decim * (gw.max_pkt_samples + 6 * max_sps)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.view_as_complex(1e-3 * torch.randn((L, 2), generator=gen, device="cuda"))
    pkts, expect = {}, set()
    for i, f_abs in enumerate(gw.channels):
        sf = gw.sfs[i % len(gw.sfs)]
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        if sf not in pkts:
            pkts[sf] = torch.from_numpy(modulate_frame(wcfg, DEADBEEF, snr_db=None)).to(
                "cuda").to(torch.complex128)
        pkt = pkts[sf]
        n = pkt.shape[0]
        pos = 2 * wcfg.samples_per_symbol
        check(pos + n <= L, f"SF{sf}: the packet does not fit the capture")
        t = torch.arange(pos, pos + n, dtype=torch.float64, device="cuda")
        cycles = torch.remainder(t * ((f_abs - gw.center_freq) / rate), 1.0)
        x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
                           ).to(torch.complex64)
        expect.add((sf, i))
    return torch.stack([x.real, x.imag]).contiguous(), expect


def plan_gate(results, expect, label: str) -> set:
    """Every placement decodes ``de ad be ef`` at its own SF and channel;
    a valid lane with any other payload fails the run, and valid lanes
    elsewhere are printed. Returns the valid lanes as ``{(sf, channel,
    start, payload)}``."""
    got, lanes, other, bad = set(), set(), [], 0
    for sf, res in results.items():
        valid = res.valid.cpu().numpy()
        chan = res.channel.cpu().numpy()[valid]
        start = res.start.cpu().numpy()[valid]
        pay = res.payload.cpu().numpy()[valid]
        plen = res.length.cpu().numpy()[valid]
        for c, st, p, n in zip(chan, start, pay, plen):
            payload = bytes(p[:n])
            lanes.add((sf, int(c), int(st), payload))
            if payload[:4] != DEADBEEF:
                bad += 1
            elif (sf, int(c)) in expect:
                got.add((sf, int(c)))
            else:
                other.append((sf, int(c), int(st)))
        for name in ("snr", "cfo"):
            check(bool(getattr(res, name)[res.valid].isfinite().all()),
                  f"{label} SF{sf}: non-finite {name}")
    print(f"plan gateway {label}: {len(got)}/{len(expect)} placements decode de ad be ef at "
          f"their own SF and channel, {len(lanes)} valid lanes, {bad} wrong payloads, "
          f"other de ad be ef lanes (sf, channel, start): {sorted(other)}")
    check(got == expect, f"{label}: placements {sorted(expect - got)[:8]} missing")
    check(bad == 0, f"{label}: {bad} valid lanes with another payload")
    return lanes


def run_plan(gw, xd, label: str, want: dict):
    """One ``process()`` call with every count zeroed just before it and
    read just after; it must launch exactly the kernels of ``want``."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    res = gw.process(xd)
    torch.cuda.synchronize()
    n = counts()
    print(f"plan gateway {label}: launches {n}")
    check(n == want, f"{label}: expected launches {want}, got {n}")
    return res, n


def phase_plan_gateway():
    """The plan gateway at full width: ``bench.py --plan-gateway`` EU868 then
    US915, with the fused channelizer; at EU868 also the factored one,
    which must decode the same lanes. Returns ``{plan: (gateway, capture,
    launches)}``."""
    import torch

    from lora_tpu_torch import PlanGateway

    out = {}
    fused_want = {"det_metrics": 0, "pfb_fir": 0, "lag_rows": 1, "fused_chan": 1}
    for plan, (center, rate) in PLAN_GEOMS.items():
        gw = PlanGateway(plan, center, rate, sfs=GATEWAY_SFS, pool=24, max_candidates=2,
                         max_symbols=24, sfd_search=12, demod_method="fft")
        check(gw.device.type == "cuda" and gw.fused, "the plan gateway did not default to "
              "the card and the fused channelizer")
        xd, expect = plan_capture(gw)
        C, D, nt = len(gw.channels), gw.decim, len(gw.taps)
        n_out = (xd.shape[-1] - nt) // D + 1
        print(f"plan gateway {plan}: {C} channels, D={D}, {nt} taps, L={xd.shape[-1]}, "
              f"n_out={n_out}, {len(expect)} placements")
        check((C, D, nt, n_out) == {"EU868": (7, 8, 77, 450551),
                                    "US915": (23, 32, 309, 450551)}[plan],
              f"{plan}: geometry {(C, D, nt, n_out)}")
        res, launches = run_plan(gw, xd, f"{plan} fused", fused_want)
        check(sorted(res) == list(GATEWAY_SFS), f"{plan}: result keys {sorted(res)}")
        lanes = plan_gate(res, expect, f"{plan} fused")
        if plan == "EU868":
            gw.fused = False
            res, _ = run_plan(gw, xd, f"{plan} factored", dict(fused_want, fused_chan=0))
            check(plan_gate(res, expect, f"{plan} factored") == lanes,
                  f"{plan}: the factored channelizer decoded other lanes than the fused one")
            gw.fused = True
            print(f"plan gateway {plan}: the factored channelizer decodes the same lanes "
                  f"(sf, channel, start, payload) as the fused one")
        out[plan] = (gw, xd, launches)
        del res
    torch.cuda.empty_cache()
    return out


def phase_plan_run_small():
    """``run()`` on a small plan capture (tests/test_plans.py:24-60: EU868 at
    868.3 MHz and 2 Msps, one packet at SF7 on 868.1 MHz and one at SF8 on
    868.5 MHz), fused and factored, on the card and on the CPU: the frames
    must agree field by field."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig, PlanGateway
    from lora_tpu_torch.tx.modulator import modulate_frame

    center, rate = 868.3e6, 2e6
    L = 40 * 4096
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)
    t = np.arange(L, dtype=np.float64)
    placements = [(7, 868.1e6), (8, 868.5e6)]
    for sf, f_abs in placements:
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, DEADBEEF + bytes([sf]), snr_db=None)
        pos = 2 * wcfg.samples_per_symbol
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * (f_abs - center) / rate
                                              * t[pos:pos + len(pkt)])
    x = x.astype(np.complex64)
    for fused in (True, False):
        kw = dict(sfs=(7, 8), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
                  demod_method="fft", fused=fused)
        frames = {dev: PlanGateway("EU868", center, rate, device=dev, **kw).run(x)
                  for dev in ("cuda", "cpu")}
        label = f"plan run() fused={fused}"
        check([(f.tap_header.sf, f.tap_header.frequency) for f in frames["cuda"]]
              == [(sf, int(f)) for sf, f in placements],
              f"{label}: {[(f.tap_header.sf, f.tap_header.frequency) for f in frames['cuda']]}")
        same_frames(frames["cuda"], frames["cpu"], label)
        check([f.tap_header.sf for f in frames["cuda"]] == [f.tap_header.sf for f in frames["cpu"]],
              f"{label}: SFs differ from the CPU's")
    print("plan run(): 2 frames at SF7 and SF8 on the EU868 raster, fused and factored, "
          "equal to the CPU's")


def phase_tools() -> dict:
    """The two kernel studies at their defaults, each run with every count
    zeroed just before it and read just after: ``profile_detect`` must
    launch K1 and K2 once for each of its calls, ``profile_packing`` K1 and
    K6, and no other kernel. Returns ``{tool: (result, counts)}``."""
    from lora_tpu_torch.tools import profile_detect, profile_packing

    out = {}
    for tool, want in ((profile_detect, {"pp": "det_metrics", "tile": "det_tile"}),
                       (profile_packing, {"pp": "det_metrics", "wm": "det_wm"})):
        name = tool.__name__.rsplit(".", 1)[-1]
        zero_counts()
        res = tool.main([])
        n = counts(tuple(_wrappers()))
        expect = {k: 0 for k in n}
        expect.update({kernel: res["calls"][v] for v, kernel in want.items()})
        print(f"{name}: launches {n}")
        check(n == expect, f"{name}: expected launches {expect}, got {n}")
        out[name] = (res, n)
    return out


def phase_timing_study() -> dict:
    """``timing_table()`` at the CLI defaults (SF7 and SF12, gradient and
    fft, 1 Msps) with ``iters=2``: every stage must be > 0, and the detect
    stages must have gone through the "pp" kernel. Then
    ``pfb_timings(1024)``. Returns the launch counts of the table's run."""
    from lora_tpu_torch.profiling import pfb_timings, timing_table

    zero_counts()
    got = {}
    table = timing_table(iters=2, timings=got)
    n = counts(tuple(_wrappers()))
    print(table)
    print(f"timing study: launches {n}")
    check(sorted(got) == [(sf, m) for sf in (7, 12) for m in ("fft", "gradient")],
          f"timing study: configs {sorted(got)}")
    for key, t in got.items():
        bad = [st for st, v in t.items() if not v > 0.0]
        check(not bad, f"timing study {key}: stages {bad} not > 0")
    # each detect stage: one warm-up call and rounds (3) x iters (2)
    want = dict(dict.fromkeys(n, 0), det_metrics=4 * 7)
    check(n == want, f"timing study: expected launches {want}, got {n}")
    pfb = pfb_timings(1024, iters=2)
    print(f"pfb_timings(1024): f32 {pfb['pfb_f32'] * 1e3:.4f} ms/Msample, "
          f"bf16 {pfb['pfb_bf16'] * 1e3:.4f} ms/Msample")
    return n


def phase_gradient(cfg, expected, fft_rx, fft_planes):
    """The gradient engine on the dense bench block, float32 planes: the
    decode gate and one K1 launch a call; its median call time beside the
    fft engine's on the same planes (a smoke reading). Returns the
    receiver, which the profile phase profiles."""
    import torch

    from lora_tpu_torch import DenseReceiver

    rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24, sfd_search=12,
                       demod_method="gradient")
    check(rx.method == "gradient" and rx.fast_sync, "the gradient engine was not selected")
    xd = fft_planes
    torch.cuda.synchronize()
    zero_counts()
    res = rx.process(xd)
    torch.cuda.synchronize()
    n = counts(tuple(_wrappers()))
    print(f"gradient engine float32: launches {n}")
    check(n == dict(dict.fromkeys(n, 0), det_metrics=1),
          f"gradient engine: expected one det_metrics launch, got {n}")
    gate(res, expected, "gradient float32")
    grad_ms = sorted(call_ms(lambda: rx.process(xd), 5))[2]
    fft_ms = sorted(call_ms(lambda: fft_rx.process(xd), 5))[2]
    print(f"gradient engine: median call {grad_ms:.3f} ms on the bench block; fft engine "
          f"{fft_ms:.3f} ms on the same planes (5 synchronised calls each)")
    return rx


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


def phase_throughput(metric, calls, when, device_name, smi_line):
    """``metric`` for each ``label -> (fn, planes, samples)`` of ``calls``:
    best of 5 rounds of 10 back-to-back ``fn(planes)`` calls with one
    synchronise a round, in Msamples/s of ``samples`` a call. Each round is
    followed by 10 single calls, each between two synchronises, on the
    same planes, so the two timings share the host's state; the line also
    gives the host's own time in a single call (until the call returns),
    the host synchronisations in a call, and the device allocations the
    caching allocator made over the rounds."""
    import torch

    control = host_syncs(lambda: torch.ones(1, device="cuda").item())
    check(len(control) == 1, f"sync debug mode saw {len(control)} syncs in one .item()")
    for label, (fn, xd, samples) in calls.items():
        iters = 10
        syncs = host_syncs(lambda: fn(xd))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_stats()
        loop_ms, single_ms, enqueue_ms = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(xd)
            torch.cuda.synchronize()
            loop_ms.append((time.perf_counter() - t0) * 1e3 / iters)
            for _ in range(iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(xd)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                single_ms.append((time.perf_counter() - t0) * 1e3)
                enqueue_ms.append((t1 - t0) * 1e3)
        mem1 = torch.cuda.memory_stats()
        print(json.dumps({
            "metric": metric, "when": when, "dtype": label,
            "value": samples / min(loop_ms) / 1e3,
            "rounds": [samples / t / 1e3 for t in loop_ms],
            "unit": "Msamples/s", "block": list(xd.shape),
            "loop_call_ms": loop_ms,
            "single_call_ms_median": sorted(single_ms)[len(single_ms) // 2],
            "single_call_ms_min": min(single_ms),
            "enqueue_ms_median": sorted(enqueue_ms)[len(enqueue_ms) // 2],
            "host_syncs_per_call": len(syncs), "host_syncs": syncs,
            "device_allocs": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                              ("num_device_alloc", "num_device_free",
                               "num_alloc_retries")},
            "device": device_name, "nvidia_smi": smi_line}))


def dense_calls(rx, planes) -> dict:
    return {str(d)[6:]: (rx.process, xd, xd.shape[0] * xd.shape[-1]) for d, xd in planes.items()}


def wideband_calls(receivers, xd) -> dict:
    return {str(d)[6:]: (wr.process, xd, xd.shape[-1]) for d, wr in receivers.items()}


def gateway_calls(gw, xd) -> dict:
    return {"bfloat16": (gw.process, xd, xd.shape[-1])}


def plan_calls(gw, xd) -> dict:
    return {"float32": (gw.process, xd, xd.shape[-1])}


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


def device_rows(fn, tries: int = 3):
    """Device time of one ``fn()`` call by kernel name (torch.profiler):
    ``(profiled call ms, [(name, ms, count)] largest first, [events a
    try])``. Device-side events only: an aten op's entry repeats its
    kernels' time, and so does a span's (``lora_tpu_torch.tracing``),
    gaps included. The profiler can drop a call's device events (seen on
    the H100: a kernel of the call missing), so the call is profiled
    ``tries`` times and the try with the most device events is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best, counts = None, []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_ms = call_ms(fn, 1)[0]
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)]
        rows.sort(key=lambda r: -r[1])
        counts.append(sum(r[2] for r in rows))
        if best is None or counts[-1] > sum(r[2] for r in best[1]):
            best = (prof_ms, rows)
    return best[0], best[1], counts


def is_gemm(name: str) -> bool:
    """A cuBLAS/CUTLASS matrix-product kernel, by its name."""
    name = name.lower()
    return any(k in name for k in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))


def phase_profile(label, calls):
    """Where one call's time goes: device time by kernel name against the
    call's wall time; the difference is the device's idle share. The idle
    share is taken against the median unprofiled call, since the profiler
    slows the host's launches."""
    out = []
    for dtype, (fn, xd, _) in calls.items():
        wall_ms = sorted(call_ms(lambda: fn(xd), 5))[2]
        prof_ms, rows, tries = device_rows(lambda: fn(xd))
        busy = sum(r[1] for r in rows)
        n_launch = sum(r[2] for r in rows)
        print(f"profile {label} {dtype}: wall {wall_ms:.3f} ms (median of 5 "
              f"unprofiled calls; {prof_ms:.3f} ms profiled), device busy "
              f"{busy:.3f} ms, idle {100 * (1 - busy / wall_ms):.1f} %, "
              f"{n_launch} device kernels and copies (device events in the "
              f"profiled tries: {tries})")
        for key, ms, count in rows[:12]:
            print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f} % x{count:<4d} {key[:90]}")
        out.append((rows, busy))
    return out


def phase_profile_wideband(receivers, xd):
    """The wideband call's device time in the layers of the path: K4, the
    DFT GEMMs (the channelizer profiled alone: its GEMM kernels), K1, and
    the rest (the active-channel gather, candidates, Phase B, decode tail)."""
    for dtype, wr in receivers.items():
        dtype = str(dtype)[6:]
        [(rows, busy)] = phase_profile("wideband", {dtype: (wr.process, xd, None)})
        _, prow, _ = device_rows(lambda: wr.pfb.planes(xd, out_dtype=wr.plane_dtype))
        k4 = sum(ms for k, ms, _ in rows if "pfb_fir" in k)
        k1 = sum(ms for k, ms, _ in rows if "det_metrics" in k)
        dft = sum(ms for k, ms, _ in prow if is_gemm(k))
        pfb = sum(ms for _, ms, _ in prow)
        print(f"profile wideband {dtype} by layer: K4 {k4:.3f} ms, DFT GEMMs {dft:.3f} ms, "
              f"rest of the channelizer {pfb - k4 - dft:.3f} ms, K1 {k1:.3f} ms, candidates + "
              f"Phase B + decode tail {busy - pfb - k1:.3f} ms, of {busy:.3f} ms busy")


def gateway_planes_seen(gw, xd) -> list:
    """One ``process()`` call with K3's wrapper and every SF's pooled stage
    wrapped to record the channel planes each is handed: ``[(who, plane
    stride, contiguous)]``."""
    from lora_tpu_torch.ops import cuda_kernels as ck

    seen, k3 = [], ck.lag_rows_kernel

    def spy_k3(xf, *a, **kw):
        seen.append(("K3", xf.stride(-2), xf.is_contiguous()))
        return k3(xf, *a, **kw)

    def spy_stage(sf, stage):
        def fn(xf, *a, **kw):
            seen.append((f"SF{sf} Phase B", xf.stride(-2), xf.is_contiguous()))
            return stage(xf, *a, **kw)
        return fn

    spy_k3.launches = 0   # the wrapper counts on whatever its module's name holds
    ck.lag_rows_kernel = spy_k3
    for sf, rx in gw.rxs.items():
        rx.process_pooled_planes = spy_stage(sf, rx.process_pooled_planes)
    try:
        gw.process(xd)
    finally:
        ck.lag_rows_kernel = k3
        for rx in gw.rxs.values():
            del rx.process_pooled_planes
    return seen


def phase_profile_gateway(gw, xd):
    """The gateway call's device time in the layers of the path: K4, the
    DFT GEMM and the rest of the channelizer (the channelizer profiled
    alone), the planes' copy (none: K3 and every SF's Phase B read the
    channelizer's pitched view, checked by wrapping them), K3, and the
    rest (the per-SF metrics, candidates, Phase B of six SFs, decode
    tails)."""
    seen = gateway_planes_seen(gw, xd)
    view = gw._channel_planes(xd)
    check(len(seen) == 1 + len(gw.rxs)
          and all(st == view.stride(-2) and not cont for _, st, cont in seen),
          f"gateway: the channel planes were copied before K3 or Phase B: {seen}")
    del view
    [(rows, busy)] = phase_profile("gateway", gateway_calls(gw, xd))
    _, prow, _ = device_rows(lambda: gw.pfb.planes(xd, out_dtype=gw.plane_dtype))
    k4 = sum(ms for k, ms, _ in rows if "pfb_fir" in k)
    k3 = sum(ms for k, ms, _ in rows if "lag_rows" in k)
    dft = sum(ms for k, ms, _ in prow if is_gemm(k))
    pfb = sum(ms for _, ms, _ in prow)
    fft = sum(ms for k, ms, _ in rows if "fft" in k.lower())
    print(f"profile gateway bfloat16 by layer: K4 {k4:.3f} ms, DFT GEMM {dft:.3f} ms, rest of "
          f"the channelizer {pfb - k4 - dft:.3f} ms, planes' copy none (K3 and the six Phase B "
          f"stages read the channelizer's view, plane stride {seen[0][1]}), K3 {k3:.3f} ms, "
          f"per-SF metrics + candidates + Phase B + decode tails {busy - pfb - k3:.3f} ms (of "
          f"which FFT kernels {fft:.3f} ms), of {busy:.3f} ms busy")


def phase_profile_plan(gw, xd):
    """The US915 plan call's device time in the layers of the path: K5, the
    planes' copy (none when the float32 planes are already contiguous),
    the shared detection (K3 and the per-SF metrics, profiled alone), and
    each SF's Phase B stage (candidates, pool, demod, decode tail; each SF
    profiled alone on the same planes and metrics)."""
    from lora_tpu_torch.rx.frontend import multi_sf_detection_metrics

    [(rows, busy)] = phase_profile("plan US915", plan_calls(gw, xd))
    k5 = sum(ms for k, ms, _ in rows if "fused_chan" in k)
    k3 = sum(ms for k, ms, _ in rows if "lag_rows" in k)
    cp = gw.channel_planes(xd)
    copy = "none (float32 planes, contiguous)" if cp.contiguous() is cp else "one copy"
    sps = {sf: rx.sps for sf, rx in gw.rxs.items()}
    metrics = multi_sf_detection_metrics(cp, sps)
    _, mrows, _ = device_rows(lambda: multi_sf_detection_metrics(cp, sps))
    det = sum(ms for _, ms, _ in mrows)
    stages = {}
    for sf, rx in gw.rxs.items():
        _, srows, _ = device_rows(
            lambda rx=rx, sf=sf: rx.process_pooled_planes(cp, gw.pool, metrics=metrics[sf]))
        stages[sf] = sum(ms for _, ms, _ in srows)
    print(f"profile plan US915 float32 by layer: K5 {k5:.3f} ms, planes' copy {copy}, K3 "
          f"{k3:.3f} ms, per-SF metrics {det - k3:.3f} ms (detection profiled alone "
          f"{det:.3f} ms), Phase B by SF (each alone) "
          + ", ".join(f"SF{sf} {ms:.3f}" for sf, ms in stages.items())
          + f" ms; parts {k5 + det + sum(stages.values()):.3f} ms, of {busy:.3f} ms busy "
          f"in the whole call")
    del cp, metrics


def fused_library_call(gw, xd):
    """The library yardstick of K5: one ``conv1d`` of the planes ``[1, 2,
    L]`` (zero-padded by the taps' padding, so its output has ``n_out``
    samples) with the real form ``[2C, 2, K*D]`` of ``g_c[k] = taps[k] *
    exp(-2j pi a_c k)``, built in float64, and ``stride = D``. It leaves
    out the output ramp, which has unit magnitude: ``|out_c[n]|`` is the
    same. Returns ``(fn, magnitudes [C, n_out])``."""
    import numpy as np
    import torch

    C, D, nt = len(gw.channels), gw.decim, len(gw.taps)
    KD = -(-nt // D) * D
    a = np.asarray(gw.offsets, np.float64) / gw.samp_rate
    tpad = np.zeros(KD, np.float64)
    tpad[:nt] = gw.taps
    g = tpad * np.exp(-2j * np.pi * ((a[:, None] * np.arange(KD)) % 1.0))     # [C, KD]
    w = np.empty((C, 2, 2, KD), np.float64)
    w[:, 0, 0], w[:, 0, 1] = g.real, -g.imag
    w[:, 1, 0], w[:, 1, 1] = g.imag, g.real
    w = torch.as_tensor(w.reshape(2 * C, 2, KD).astype(np.float32), device=xd.device)
    xin = torch.nn.functional.pad(xd, (0, KD - nt)).unsqueeze(0)

    def fn():
        return torch.nn.functional.conv1d(xin, w, stride=D)

    y = fn()[0].view(C, 2, -1)
    return fn, torch.hypot(y[:, 0], y[:, 1])


def detection_bound(shape, in_bytes: int, out_floats: int):
    """``(bound ms, bytes ms, ops ms, "bytes" | "operations")`` of a
    detection metric over planes of ``shape`` (``in_bytes`` a sample
    plane value): the planes read once and ``out_floats`` float32 outputs
    written once; 12 float32 flops a complex sample (dot re/im, energy)."""
    import math

    n = math.prod(shape)
    t_bytes = (n * in_bytes + out_floats * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * (n // 2) / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, "bytes" if t_bytes >= t_ops else "operations"


def phase_variant_times(xd, sps: int) -> dict:
    """K1, K2 and K6 timed in one run, in turns (K1, K2, K6, K6, K2, K1),
    on the dense bench block's float32 planes ``xd`` (K6 on their
    window-major copy, made on the card) and at the studies' 268 MB shape;
    beside each one's bound and, on the bench block, K2's and K6's plain
    versions. Returns ``{name: stats}`` of the bench block."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes,
                                                 detection_metrics_wm_kernel,
                                                 detection_metrics_wm_planes)

    gen = torch.Generator(device="cuda").manual_seed(99)
    out = {}
    shapes = {"bench block": xd,
              "studies' shape": torch.randn((16, 2, 2048 * sps), generator=gen, device="cuda")}
    for label, x in shapes.items():
        C, _, L = x.shape
        K1 = L // sps
        xw = x[..., :K1 * sps].reshape(C, 2, K1, sps).permute(0, 2, 1, 3).contiguous()
        fns = {"det_metrics": lambda: detection_metrics_kernel(x, sps),
               "det_tile": lambda: detection_metrics_kernel(x, sps, variant="tile"),
               "det_wm": lambda: detection_metrics_wm_kernel(xw)}
        ms = {k: [] for k in fns}
        for k in ("det_metrics", "det_tile", "det_wm", "det_wm", "det_tile", "det_metrics"):
            ms[k].append(cuda_ms(fns[k], 20))
        bounds = {"det_metrics": detection_bound(x.shape, 4, C * (2 * K1 - 1)),
                  "det_tile": detection_bound(x.shape, 4, C * (2 * K1 - 1)),
                  "det_wm": detection_bound(xw.shape, 4, C * 2 * K1)}
        print(f"detection kernels float32 at {list(x.shape)} ({label}, "
              f"{x.numel() * 4 / 1e9:.3f} GB), two turns each: "
              + "; ".join(f"{k} {a:.4f} / {b:.4f} ms (bound {bounds[k][0]:.4f}, by "
                          f"{bounds[k][3]})" for k, (a, b) in ms.items()))
        if label == "bench block":
            plain = {"det_tile": cuda_ms(lambda: detection_metrics_planes(x, sps), 5),
                     "det_wm": cuda_ms(lambda: detection_metrics_wm_planes(xw), 5)}
            for k in ("det_tile", "det_wm"):
                out[k] = dict(ms=min(ms[k]), plain_ms=plain[k], bound_ms=bounds[k][0],
                              bound_by=bounds[k][3])
                print(f"{k} float32 at the bench block: kernel {out[k]['ms']:.4f} ms (best "
                      f"turn), plain {plain[k]:.4f} ms, bound {bounds[k][0]:.4f} ms (bytes "
                      f"{bounds[k][1]:.4f}, ops {bounds[k][2]:.4f})")
        del xw
    del shapes
    torch.cuda.empty_cache()
    return out


def pfb_times(xd, h, dtype, kernel=None, n: int = 20) -> dict:
    """K4 on the planes ``xd [2, L]`` with the taps ``h [K, M]`` into
    ``dtype``: its time (``kernel()``, by default the port's wrapper; CUDA
    events, mean of ``n`` launches), the plain version's, and the
    ``conv1d(groups=M)`` yardstick's (cuDNN, TF32 off, on the planes
    pre-transposed to ``[2, M, n_vec]`` outside the timing, operands in
    ``dtype``; conv1d correlates, so its weights are the taps as they
    stand), beside the bound: the planes and taps read once and the output
    written once at the memory rate, or one multiply and one add a tap and
    output at the float32 rate, whichever is longer."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import pfb_fir_kernel, pfb_fir_planes

    K, M = h.shape
    n_vec = xd.shape[-1] // M
    n_out = n_vec - K + 1
    out_size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * n_vec * M * xd.element_size() + K * M * 4
               + 2 * n_out * M * out_size) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * K * 2 * n_out * M / F32_FLOPS_PER_S * 1e3
    xt = xd[:, : n_vec * M].reshape(2, n_vec, M).transpose(1, 2).contiguous().to(dtype)
    w = h.t().contiguous().to(dtype).unsqueeze(1)            # [M, 1, K]
    conv = torch.nn.functional.conv1d(xt, w, groups=M)      # [2, M, n_out]
    ref = pfb_fir_planes(xd, h, dtype)
    lib_err = float((conv.float().transpose(1, 2) - ref.float()).abs().max())
    del conv, ref
    kernel = kernel or (lambda: pfb_fir_kernel(xd, h, dtype))
    st = dict(ms=cuda_ms(kernel, n),
              plain_ms=cuda_ms(lambda: pfb_fir_planes(xd, h, dtype), 3),
              library_ms=cuda_ms(lambda: torch.nn.functional.conv1d(xt, w, groups=M), n),
              bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
              t_bytes=t_bytes, t_ops=t_ops, lib_err=lib_err,
              shape=f"{str(xd.dtype)[6:]}->{str(dtype)[6:]} at M={M} n_vec={n_vec} K={K}")
    del xt, w
    torch.cuda.empty_cache()
    return st


def pfb_tile(xd, h, dtype) -> dict:
    """The tile K4 takes on the planes ``xd`` with the taps ``h`` into
    ``dtype`` (threads across, row groups, rows a step, shared bytes,
    vector width), from the launcher itself, launching nothing."""
    import torch

    from lora_tpu_torch.ops.cuda_kernels import _pfb_lib, pfb_fir_geometry

    out = torch.empty((1, 2, h.shape[1]), dtype=dtype, device=xd.device)
    geo = pfb_fir_geometry(_pfb_lib(), xd, h, out)
    return {k: geo[k] for k in ("Tc", "G", "S", "ring_bytes", "vec")}


def print_pfb_times(label: str, st: dict, extra: str = "") -> None:
    print(f"pfb_fir {label} {st['shape']}: kernel {st['ms']:.4f} ms "
          f"({100 * st['bound_ms'] / st['ms']:.1f} % of the bound), plain "
          f"{st['plain_ms']:.4f} ms, conv1d(groups=M) {st['library_ms']:.4f} ms (max abs diff to "
          f"plain {st['lib_err']:.3g}), bound {st['bound_ms']:.4f} ms (bytes "
          f"{st['t_bytes']:.4f}, ops {st['t_ops']:.4f})"
          + (f", tile {st['geometry']}" if "geometry" in st else "")
          + (f", {extra}" if extra else ""))


def phase_kernel_times(rx, planes, launches, worst_err, receivers, xd_wide,
                       wide_launches, worst_fir, gw, xd_gw, gw_launches, worst_lag,
                       plans, worst_fused, variants, tools, worst_variants,
                       facade_launches, graph_launches, shard_launches, coarse_fir):
    import torch

    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes,
                                                 lag_rows_kernel, lag_rows_planes)

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
              f"launches per process() {launches[dtype]['det_metrics']}")

    # K4 at the wideband path's shape (float32 planes in, the receiver's
    # plane dtype out) and at the gateway's (float32 in, bf16 out)
    fir = {}
    for dtype, wr in receivers.items():
        fir[dtype] = pfb_times(xd_wide, wr.pfb._h, dtype)
        fir[dtype]["geometry"] = pfb_tile(xd_wide, wr.pfb._h, dtype)
        print_pfb_times(f"wideband-{wr.M}", fir[dtype],
                        f"launches per process() {wide_launches[dtype]['pfb_fir']}")
    fir_gw = pfb_times(xd_gw, gw.pfb._h, gw.plane_dtype)
    fir_gw["geometry"] = pfb_tile(xd_gw, gw.pfb._h, gw.plane_dtype)
    print_pfb_times(f"gateway-{gw.M}", fir_gw, f"launches per process() {gw_launches['pfb_fir']}")
    # K3 at the gateway's shape (the bf16 channel planes as the receiver
    # hands them over: the channelizer's pitched view) and at the US915
    # plan gateway's (its contiguous float32 planes); rows of one SF7
    # symbol, every SF's lag. Timed through the C entry into a
    # preallocated output: the wrapper's own host work a call outlasts
    # the kernel at the plan shape, so back-to-back wrapper calls would
    # time the host
    from lora_tpu_torch.ops.cuda_kernels import _lag_lib, lag_rows_launch

    lag = {}
    sps = min(r.sps for r in gw.rxs.values())
    pgw, pxd, plaunches = plans["US915"]
    for where, cp, n_launch in (("gateway", gw._channel_planes(xd_gw), gw_launches),
                                ("plan", pgw.channel_planes(pxd), plaunches)):
        bound, t_bytes, t_ops, by = lag_bound(cp.shape, cp.element_size(), sps, GATEWAY_LAGS)
        rows = torch.empty((cp.shape[0], 1 + 2 * len(GATEWAY_LAGS), cp.shape[-1] // sps),
                           device=cp.device)
        lag[where] = dict(ms=cuda_ms(lambda: lag_rows_launch(_lag_lib(), cp, sps, GATEWAY_LAGS,
                                                             rows), 20),
                          plain_ms=cuda_ms(lambda: lag_rows_planes(cp, sps, GATEWAY_LAGS), 3),
                          bound_ms=bound, bound_by=by, library_ms=None,
                          launches=n_launch["lag_rows"])
        st = lag[where]
        print(f"lag_rows {where} {str(cp.dtype)[6:]} at {list(cp.shape)} plane stride "
              f"{cp.stride(1)} ({lag_copies(cp, sps, GATEWAY_LAGS)}) sps={sps} "
              f"lags={GATEWAY_LAGS}: kernel {st['ms']:.4f} ms ({100 * bound / st['ms']:.1f} % "
              f"of the bound), through the wrapper "
              f"{cuda_ms(lambda: lag_rows_kernel(cp, sps, GATEWAY_LAGS), 20):.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, bound {bound:.4f} ms (bytes {t_bytes:.4f}, ops "
              f"{t_ops:.4f}), launches per process() {st['launches']}")
        if where == "gateway":
            cc = cp.contiguous()
            six_k1 = cuda_ms(lambda: [detection_metrics_kernel(cc, m * sps)
                                      for m in GATEWAY_LAGS], 10)
            on_copy = cuda_ms(lambda: lag_rows_launch(_lag_lib(), cc, sps, GATEWAY_LAGS, rows), 20)
            print(f"  on the planes' contiguous copy (the scalar instantiation) {on_copy:.4f} "
                  f"ms; the copy itself {cuda_ms(lambda: cp.contiguous(), 20):.4f} ms; the six "
                  f"per-SF det_metrics launches K3 replaces (on the copy) {six_k1:.4f} ms")
            del cc
        del cp, rows
    # K5 at both plan shapes: the gateway's own tables for its capture
    from lora_tpu_torch.device import full_f32_matmul
    from lora_tpu_torch.ops.cuda_kernels import fused_channelize_kernel, fused_channelize_planes

    fused = {}
    for plan, (pgw, xd, plaunches) in plans.items():
        g2, mix, L = pgw._g2, pgw._mix, xd.shape[-1]
        ramp = pgw._tables[("fused", L)]
        C, D, nt = len(pgw.channels), pgw.decim, len(pgw.taps)
        n_out = (L - nt) // D + 1
        # operations: the least the function needs (fused_min_ops); bytes:
        # the planes, the kernel's tables (taps, phases, ramp) read once,
        # the output written once
        t_ops = fused_min_ops(C, D, nt, n_out) / F32_FLOPS_PER_S * 1e3
        t_bytes = (xd.numel() + sum(t.numel() for t in (*mix, *ramp))
                   + C * 2 * n_out) * 4 / HBM_BYTES_PER_S * 1e3
        with full_f32_matmul():
            lib_fn, lib_mag = fused_library_call(pgw, xd)
            out = fused_channelize_kernel(xd, g2, ramp, D, nt, mix)
            mag_err = float((torch.hypot(out[:, 0], out[:, 1]) - lib_mag).abs().max())
            st = dict(ms=cuda_ms(lambda: fused_channelize_kernel(xd, g2, ramp, D, nt, mix), 20),
                      plain_ms=cuda_ms(lambda: fused_channelize_planes(xd, g2, ramp, D, nt,
                                                                       pgw._fused_tile), 5),
                      library_ms=cuda_ms(lib_fn, 20),
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations")
        fused[plan] = st
        issued = fused_kernel_ops(C, D, nt, n_out)
        del out, lib_mag, lib_fn
        print(f"fused_chan {plan} float32 at L={L} C={C} D={D} taps={nt} n_out={n_out}: kernel "
              f"{st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, conv1d(stride=D, cuDNN TF32 "
              f"off; no output ramp) {st['library_ms']:.4f} ms (its |out| within {mag_err:.3g} "
              f"of the kernel's), bound {st['bound_ms']:.4f} ms (ops {t_ops:.4f}, bytes "
              f"{t_bytes:.4f}; {100 * st['bound_ms'] / st['ms']:.1f} % of it), "
              f"{issued / st['ms'] / 1e9:.1f} TFLOP/s of the kernel's own factored form "
              f"({issued / fused_min_ops(C, D, nt, n_out):.2f}x the least flops; "
              f"{100 * issued / F32_FLOPS_PER_S * 1e3 / st['ms']:.1f} % of the float32 rate), "
              f"launches per process() {plaunches['fused_chan']}")
    torch.cuda.empty_cache()
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    st, sf = stats[torch.float32], fir[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "det_metrics",
        "route": "cuda",
        "source": "lora_tpu_torch/csrc/det_metrics.cu",
        "replaces": "lora_tpu/ops/pallas_kernels.py:85",
        "launches": launches[torch.float32]["det_metrics"],
        "max_abs_err": worst_err,
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": None,
        # launches a receive() of the facade, by its channel count
        "facade": {str(c): n["det_metrics"] for c, n in facade_launches.items()},
        # launches in a flowgraph's run, by graph
        "flowgraph": {g: n["det_metrics"] for g, n in graph_launches.items()},
        # launches in a sharded call, by part of phase_sharding
        "sharding": {p: n["det_metrics"] for p, n in shard_launches.items()},
    }, {
        "name": "pfb_fir",
        "route": "cuda",
        "source": "lora_tpu_torch/csrc/pfb_fir.cu",
        "replaces": "lora_tpu/ops/pallas_kernels.py:275",
        "launches": wide_launches[torch.float32]["pfb_fir"],
        "max_abs_err": worst_fir,
        "ms": sf["ms"],
        "plain_ms": sf["plain_ms"],
        "bound_ms": sf["bound_ms"],
        "bound_by": sf["bound_by"],
        "library_ms": sf["library_ms"],
        "geometry": sf["geometry"],
        "gateway": {k: fir_gw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "geometry")}
        | {"launches": gw_launches["pfb_fir"]},
        "flowgraph": {g: n["pfb_fir"] for g, n in graph_launches.items()},
        "sharding": {p: n["pfb_fir"] for p, n in shard_launches.items()},
        # the subband path's coarse filterbank (M = 8, K = 13); its launches
        # are those of the gated (d) call, split by filterbank; then the same
        # planes with the prototype at M = 4 and 1 (no launch on that path)
        **{("coarse" if n == 8 else f"coarse_m{n}"): {
            k: coarse_fir[n][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "launches", "geometry")}
           for n in (8, 4, 1)},
    }, {
        "name": "lag_rows",
        "route": "cuda",
        "source": "lora_tpu_torch/csrc/lag_rows.cu",
        "replaces": "lora_tpu/ops/pallas_kernels.py:149",
        "launches": gw_launches["lag_rows"],
        "max_abs_err": worst_lag,
        "ms": lag["gateway"]["ms"],
        "plain_ms": lag["gateway"]["plain_ms"],
        "bound_ms": lag["gateway"]["bound_ms"],
        "bound_by": lag["gateway"]["bound_by"],
        "library_ms": None,
        "plan": lag["plan"],
        "flowgraph": {g: n["lag_rows"] for g, n in graph_launches.items()},
    }, {
        "name": "fused_chan",
        "route": "cuda",
        "source": "lora_tpu_torch/csrc/fused_chan.cu",
        "replaces": "lora_tpu/ops/pallas_kernels.py:386",
        "launches": plans["US915"][2]["fused_chan"],
        "max_abs_err": worst_fused,
        "ms": fused["US915"]["ms"],
        "plain_ms": fused["US915"]["plain_ms"],
        "bound_ms": fused["US915"]["bound_ms"],
        "bound_by": fused["US915"]["bound_by"],
        "library_ms": fused["US915"]["library_ms"],
        "flowgraph": {g: n["fused_chan"] for g, n in graph_launches.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"lora_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": tools[tool][1][name],
        "max_abs_err": worst_variants[name],
        "ms": variants[name]["ms"],
        "plain_ms": variants[name]["plain_ms"],
        "bound_ms": variants[name]["bound_ms"],
        "bound_by": variants[name]["bound_by"],
        "library_ms": None,
    } for name, tool, replaces in (
        ("det_tile", "profile_detect", "lora_tpu/ops/pallas_kernels.py:28"),
        ("det_wm", "profile_packing", "tools/profile_packing.py:32"))]}))


# ------------------------------------------------------------ streaming
STREAM_CHUNK = 1_000_003        # odd push size: blocks straddle pushes
STREAM_BLOCKS = 4               # hops a capture spans: at least three blocks


def host_syncs_in(fn) -> list:
    """Host-device synchronisations in ``fn()``: those torch's sync debug
    mode reports (``host_syncs``), then one ``"Event.synchronize"`` for
    each CUDA event ``fn`` waits on, which the mode does not report."""
    import torch

    waited, sync = [], torch.cuda.Event.synchronize

    def counted(ev):
        waited.append("Event.synchronize")
        return sync(ev)

    torch.cuda.Event.synchronize = counted
    try:
        reported = host_syncs(fn)
    finally:
        torch.cuda.Event.synchronize = sync
    return reported + waited


def stream_push(sr, x, chunk: int = STREAM_CHUNK, syncs=None):
    """Push the host capture ``x`` in ``chunk``-sample pieces, then flush;
    returns ``(frames, wall seconds from the first push to flush()'s
    return)``. With ``syncs`` (a dict), every block's enqueue and every
    drain are wrapped to count their host synchronisations: ``syncs
    ["enqueue"]`` one count a block, ``syncs["drain"]`` ``(syncs, blocks
    drained)`` a call."""
    if syncs is not None:
        enqueue, drain = sr._enqueue, sr._drain

        def counted_enqueue(*a):
            syncs["enqueue"].append(host_syncs_in(lambda: enqueue(*a)))

        def counted_drain(keep):
            before = len(sr._pending)
            syncs["drain"].append((len(host_syncs_in(lambda: drain(keep))),
                                   before - len(sr._pending)))

        syncs.update(enqueue=[], drain=[])
        sr._enqueue, sr._drain = counted_enqueue, counted_drain
    t0 = time.perf_counter()
    frames = []
    for off in range(0, len(x), chunk):
        frames += sr.push(x[off:off + chunk])
    frames += sr.flush()
    wall = time.perf_counter() - t0
    if syncs is not None:
        del sr._enqueue, sr._drain
    return frames, wall


def stream_gate(frames, placements, label: str, sps_of, fault=None) -> None:
    """Every placement ``(sf, channel, index, payload)`` is decoded exactly
    once: by one frame at its SF (``tap_header.sf``; 0 for the dense
    stream) and channel whose ``sample_index`` lies within 3 symbols of
    ``index`` (``sps_of(sf)`` channel-rate samples a symbol) and whose
    payload starts with ``payload``; and no other frame is emitted.

    ``fault(frame)``: true for a frame that the receiver itself decodes
    wrongly, the fault ROADMAP.md §3 logs (the fft drift pass, SF11-12,
    mis-rounding a clean packet whose tones sit near half a bin: a
    CRC-failing payload, the same in one call over the whole capture and
    in JAX's receiver). Such a frame still has to be the one frame at its
    placement; it is printed, not counted as the streamer's error."""
    import bisect

    by_key = {}
    for i, f in enumerate(frames):
        by_key.setdefault((f.tap_header.sf, f.channel), []).append((f.sample_index, i))
    for v in by_key.values():
        v.sort()
    used, missing, faulty = set(), [], []
    for sf, chan, idx, payload in placements:
        near = by_key.get((sf, chan), [])
        tol = 3 * sps_of(sf)
        lo = bisect.bisect_left(near, (idx - tol, -1))
        hi = bisect.bisect_right(near, (idx + tol, len(frames)))
        hits = [i for _, i in near[lo:hi] if frames[i].payload[:len(payload)] == payload]
        if not hits and fault is not None and len(near[lo:hi]) == 1 \
                and fault(frames[near[lo][1]]):
            hits = [near[lo][1]]
            f = frames[hits[0]]
            faulty.append((sf, chan, idx, payload.hex(), f.payload.hex()))
        if len(hits) != 1:
            missing.append((sf, chan, idx, len(hits)))
        used.update(hits)
    extra = [(f.tap_header.sf, f.channel, f.sample_index, f.payload[:6].hex())
             for i, f in enumerate(frames) if i not in used]
    print(f"stream {label}: {len(placements) - len(missing)}/{len(placements)} placements "
          f"decoded exactly once at their placement, {len(frames)} frames, {len(extra)} "
          f"other frames")
    for sf, chan, idx, sent, got in faulty:
        print(f"stream {label}: KNOWN RECEIVER FAULT (ROADMAP.md section 3, the fft drift "
              f"pass): SF{sf} channel {chan} at {idx} sent {sent}, decoded {got} (CRC fails), "
              f"the same in one run() over the whole capture")
    check(not missing and not extra, f"{label}: placements not decoded exactly once (sf, "
          f"channel, index, hits): {missing[:8]}; frames that match no placement (sf, "
          f"channel, index, payload): {extra[:8]}")


def stream_vs_oneshot(frames, oneshot, label: str, sps_of) -> None:
    """The streamed frames are the one-shot ``run()``'s: the same SF,
    channel, frequency, PHY header and payload, frame for frame, and
    sample indices within one symbol of the decoding SF (a packet whose
    rising edge falls on a block's first window is reported one window
    later than in one call over the whole capture, as the JAX streamer
    reports it)."""
    def keyed(fs):
        return sorted(((f.tap_header.sf, f.channel, f.tap_header.frequency,
                        f.phy_header.to_bytes(), f.payload), f.sample_index) for f in fs)

    a, b = keyed(frames), keyed(oneshot)
    same = [k for k, _ in a] == [k for k, _ in b]
    moved = [(k[0], k[1], ia - ib) for (k, ia), (_, ib) in zip(a, b) if ia != ib]
    far = [m for m in moved if abs(m[2]) > sps_of(m[0])]
    print(f"stream {label}: {len(a)} streamed frames, {len(b)} from one run() of the whole "
          f"capture: {'the same' if same else 'NOT the same'} frames, {len(moved)} sample "
          f"indices moved (sf, channel, streamed - one-shot): {moved[:6]}")
    check(same, f"{label}: the streamed frames differ from run()'s: "
          f"{sorted(set(k for k, _ in a) ^ set(k for k, _ in b))[:4]}")
    check(not far, f"{label}: sample indices more than a symbol from run()'s: {far[:8]}")


def check_stream_syncs(syncs, label: str) -> None:
    """A block's enqueue makes no host synchronisation; a drain makes one
    for each block it drains."""
    n_drained = sum(b for _, b in syncs["drain"])
    bad = [(s, b) for s, b in syncs["drain"] if s != b]
    seen = [(k, s) for k, s in enumerate(syncs["enqueue"]) if s]
    print(f"stream {label}: host syncs: {sum(map(len, syncs['enqueue']))} in "
          f"{len(syncs['enqueue'])} block enqueues, {sum(s for s, _ in syncs['drain'])} in "
          f"drains of {n_drained} blocks")
    check(len(syncs["enqueue"]) == n_drained, f"{label}: {len(syncs['enqueue'])} blocks "
          f"enqueued, {n_drained} drained")
    check(not seen, f"{label}: enqueues made host syncs (block, where): {seen[:4]}")
    check(not bad, f"{label}: drains (syncs, blocks) {bad[:8]}")


def run_stream(make, x, label: str, want: dict):
    """Two streamed runs of ``x``, each through a fresh streamer ``make()``
    on one receiver, after one call of the receiver on a block of zeros
    (set-up: its first call at the block length builds its tables for that
    length, with host-to-card copies). The first is timed, unwrapped, from
    the first push to ``flush()``'s return. The second has every count
    zeroed just before it and read just after (each kernel of ``want``
    once a block: a block is one receiver call), counts the host
    synchronisations of every block's enqueue and drain, and must give
    the first run's frames. Returns ``(frames, wall seconds)``."""
    import torch

    sr = make()
    # set-up: the receiver's tables for the block length, built at its
    # first call of that length
    sr._process(torch.zeros((2, sr.block_len), device="cuda"))
    torch.cuda.synchronize()
    timed, wall = stream_push(sr, x)
    sr.close()
    sr = make()
    calls = [0]
    process = sr._process

    def counted(planes):
        calls[0] += 1
        return process(planes)

    sr._process = counted
    syncs = {}
    torch.cuda.synchronize()
    zero_counts()
    frames, _ = stream_push(sr, x, syncs=syncs)
    torch.cuda.synchronize()
    n = counts()
    sr.close()
    expect = {k: want.get(k, 0) * calls[0] for k in n}
    print(f"stream {label}: {calls[0]} blocks of {sr.block_len} samples (hop {sr.hop}, halo "
          f"{sr.halo}), launches {n}; {len(x) / wall / 1e6:.2f} Msamples/s streamed "
          f"({len(x)} samples, {wall * 1e3:.1f} ms from the first push to flush()'s return, "
          f"{wall * 1e3 * sr.hop / len(x):.2f} ms a hop)")
    check(calls[0] >= 3, f"{label}: {calls[0]} blocks")
    check(n == expect, f"{label}: expected launches {expect}, got {n}")
    check_stream_syncs(syncs, label)
    check(frame_keys(timed) == frame_keys(frames), f"{label}: the two runs gave other frames")
    return frames, wall


def frame_keys(frames) -> list:
    return sorted((f.tap_header.sf, f.channel, f.sample_index, f.phy_header.to_bytes(),
                   f.payload) for f in frames)


def dense_stream(x, pkt_len: int):
    """The dense bench block's 64 rows laid end to end as one stream, each
    row's trailing partial packet zeroed. Returns ``(stream, placements)``:
    the placements ``(0, 0, preamble start, deadbeef)``."""
    import numpy as np

    C, L = x.shape
    rows = x.copy()
    placements = []
    for c in range(C):
        n = (L - 997 * c) // pkt_len
        rows[c, 997 * c + n * pkt_len:] = 0
        placements += [(0, 0, c * L + 997 * c + i * pkt_len + 4096, DEADBEEF)
                       for i in range(n)]
    return rows.reshape(-1), placements


def phase_stream_dense(cfg, x, pkt_len, smi_line):
    """(a) ``StreamingReceiver`` on the dense geometry (SF7 CR4/8 at 1 Msps,
    fft engine), native ring, pushes of an odd size, ``max_in_flight=2``,
    ``block_symbols=512``: the bench block's rows end to end (134,217,728
    samples). Gates: every packet once at its placement, and the frames of
    one ``run()`` over the whole stream."""
    from lora_tpu_torch import DenseReceiver
    from lora_tpu_torch.stream import StreamingReceiver

    stream, placements = dense_stream(x, pkt_len)
    rx = DenseReceiver(cfg, max_candidates=16, max_symbols=24, sfd_search=12,
                       demod_method="fft")
    def make():
        return StreamingReceiver(rx, block_symbols=512, max_in_flight=2, use_native_ring=True)

    sr = make()
    sr.close()
    check((sr.hop, sr.halo) == (524_288, 52_224), f"dense stream geometry {sr.hop}, {sr.halo}")
    frames, wall = run_stream(make, stream, "(a) dense", {"det_metrics": 1})
    one = DenseReceiver(cfg, max_candidates=4096, max_symbols=24, sfd_search=12,
                        demod_method="fft")
    stream_vs_oneshot(frames, one.run(stream), "(a) dense", lambda sf: rx.sps)
    stream_gate(frames, placements, "(a) dense", lambda sf: rx.sps)
    print(f"stream (a) dense: {len(stream) / wall / 1e6:.2f} Msamples/s on {smi_line}")
    return len(stream) / wall


def wideband_stream_capture(cfg, M: int, active, L: int, seed: int = 6, device: str = "cuda"):
    """A wideband capture of ``L`` samples built on the card (noise sigma
    1e-3 a part) with one ``deadbeef`` packet of ``cfg`` (a channel-rate
    config) on each channel of ``active``, at positions spread evenly over
    the capture, upconverted with a float64 carrier phase. Returns ``(host
    complex64 capture, placements, packet length)``: channel-rate
    placements."""
    import dataclasses
    import math

    import torch

    from lora_tpu_torch.channelizer import pfb_channel_freqs
    from lora_tpu_torch.tx.modulator import modulate_frame

    wide_rate = M * cfg.samp_rate
    wide_cfg = dataclasses.replace(cfg, samp_rate=wide_rate)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.view_as_complex(1e-3 * torch.randn((L, 2), generator=gen, device=device))
    pkt = torch.from_numpy(modulate_frame(wide_cfg, DEADBEEF, snr_db=None)).to(device)
    pkt = pkt.to(torch.complex128)
    n = pkt.shape[0]
    t = torch.arange(n, dtype=torch.float64, device=device)
    freqs = pfb_channel_freqs(wide_rate, M)
    placements = []
    for j, c in enumerate(active):
        pos = j * (L - n - 1) // len(active)
        cycles = torch.remainder((t + pos) * (freqs[c] / wide_rate), 1.0)
        x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
                           ).to(torch.complex64)
        placements.append((cfg.sf, c, pos // M, DEADBEEF))
    return x.cpu().numpy(), placements, n


def phase_stream_wideband(smi_line):
    """(b) ``WidebandStreamingReceiver`` on a ``WidebandReceiver`` at M =
    1024 (SF7 CR4/8 channels at 250 ksps, every 16th active, ``pool=128``,
    float32 planes), ``block_symbols=64``: a capture of four hops (~67 M
    samples, longer than one ~30 M-sample block) with a packet on each
    active channel, spread over the capture. Gates as (a)."""
    from lora_tpu_torch import LoRaConfig, WidebandReceiver
    from lora_tpu_torch.stream import WidebandStreamingReceiver

    M = 1024
    active = list(range(0, M, 16))
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wr = WidebandReceiver(cfg, M, pool=2 * len(active), max_candidates=2, max_symbols=24,
                          sfd_search=12, demod_method="fft")
    def make():
        return WidebandStreamingReceiver(wr, block_symbols=64, max_in_flight=2)

    sr = make()
    sr.close()
    x, placements, n = wideband_stream_capture(cfg, M, active, STREAM_BLOCKS * sr.hop)
    seams = sum(any(p[2] * M < k * sr.hop < p[2] * M + n for p in placements)
                for k in range(1, STREAM_BLOCKS))
    print(f"stream (b) wideband M={M}: {len(placements)} packets of {n} samples over "
          f"{len(x)} samples, {seams} of {STREAM_BLOCKS - 1} seams with a packet across")
    check(seams >= 1, "(b): no packet across a seam")
    frames, wall = run_stream(make, x, f"(b) wideband M={M}", {"det_metrics": 1, "pfb_fir": 1})
    stream_vs_oneshot(frames, wr.run(x), "(b) wideband", lambda sf: wr.rx.sps)
    stream_gate(frames, placements, "(b) wideband", lambda sf: wr.rx.sps)
    print(f"stream (b) wideband: {len(x) / wall / 1e6:.2f} Msamples/s on {smi_line}")
    return len(x) / wall


def plan_stream_capture(gw, L: int, hop: int, seed: int = 8, device: str = "cuda"):
    """The EU868 plan capture streamed in (c) and (d), built on the card:
    ``L`` samples of noise (sigma 1e-3 a part) and two packets on every
    in-band channel, SFs 7-12 round-robin: the first spread over the
    capture, the second starting one SF12 symbol before a block seam
    (``hop``) that leaves it clear of the first. Returns ``(host complex64
    capture, placements)``: channel-rate preamble starts."""
    import math

    import torch

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    rate, D = gw.samp_rate, gw.decim
    sym12 = 2 ** 12 * D * 2          # an SF12 symbol at the wideband rate
    seams = [k * hop for k in range(1, L // hop)]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.view_as_complex(1e-3 * torch.randn((L, 2), generator=gen, device=device))
    C = len(gw.channels)
    placements = []
    for i, f_abs in enumerate(gw.channels):
        first = None
        for j in range(2):
            sf = gw.sfs[(i + 3 * j) % len(gw.sfs)]
            wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
            payload = DEADBEEF + bytes([i, j])
            pkt = torch.from_numpy(modulate_frame(wcfg, payload, snr_db=None)).to(device)
            pkt = pkt.to(torch.complex128)
            n = pkt.shape[0]
            if j == 0:
                pos = (i * (L - n - 1) // C) // D * D
                first = (pos, pos + n)
            else:
                clear = [s - sym12 for s in seams[i % len(seams):] + seams[:i % len(seams)]
                         if s - sym12 + n + sym12 < first[0] or s - 2 * sym12 > first[1]]
                check(bool(clear), f"channel {i}: no seam clear of its first packet")
                pos = clear[0]
            check(0 <= pos and pos + n <= L, f"SF{sf}: the packet does not fit the capture")
            t = torch.arange(pos, pos + n, dtype=torch.float64, device=device)
            cycles = torch.remainder(t * ((f_abs - gw.center_freq) / rate), 1.0)
            x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
                               ).to(torch.complex64)
            placements.append((sf, i, pos // D, payload))
    return x.cpu().numpy(), placements


def ring_and_copy_rates(block_len: int, smi_line: str) -> None:
    """The host side of one block: the ring's write and peek of
    ``block_len`` complex64 (host clock, best of 5), and the block's
    host-to-card copy from a page-locked slot (``non_blocking``) against a
    pageable ``.to()`` (CUDA events, mean of 10)."""
    import numpy as np
    import torch

    from lora_tpu_torch.native import SampleRing

    nbytes = block_len * 8
    x = np.random.default_rng(0).normal(size=(block_len, 2)).astype(np.float32)
    x = x.view(np.complex64).reshape(-1)
    slot = torch.empty(block_len, dtype=torch.complex64, pin_memory=True)
    ring = SampleRing(8 * nbytes)
    t_w, t_p = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        check(ring.write(x) == nbytes, "ring write short")
        t1 = time.perf_counter()
        check(ring.peek_into(slot) == nbytes, "ring peek short")
        t_p.append(time.perf_counter() - t1)
        t_w.append(t1 - t0)
        ring.advance(nbytes)
    ring.close()
    check(np.array_equal(slot.numpy(), x), "ring: peeked block differs from the written one")
    pinned = cuda_ms(lambda: slot.to("cuda", non_blocking=True), 10)
    src = torch.from_numpy(x)
    pageable = cuda_ms(lambda: src.to("cuda"), 10)
    print(f"ring (host, {nbytes / 1e6:.1f} MB block): write {nbytes / min(t_w) / 1e9:.2f} GB/s, "
          f"peek into a pinned slot {nbytes / min(t_p) / 1e9:.2f} GB/s, write+peek "
          f"{2 * nbytes / (min(t_w) + min(t_p)) / 1e9:.2f} GB/s; host-to-card copy of the block: "
          f"pinned non_blocking {pinned:.3f} ms ({nbytes / pinned / 1e6:.2f} GB/s), pageable "
          f".to() {pageable:.3f} ms ({nbytes / pageable / 1e6:.2f} GB/s); on {smi_line}")


def phase_stream_plan(smi_line):
    """(c) ``WidebandStreamingReceiver`` on the EU868 ``PlanGateway`` (868.0
    MHz, 2 Msps, SF7-12, ``pool=24``), ``block_symbols=64`` (hop 4,194,304,
    block 7,536,728 samples): four hops with 14 packets, 7 across seams.
    Gates as (a); then the ring's and the copy's rates at its block, and
    the device's idle share over a streamed run (device busy, profiled,
    against the unprofiled run's wall time). (d) ``lora_tpu_torch.cli
    gateway --plan EU868 --stream`` on a file of the same capture: every
    placement once, the same frame lines as (c)'s frames."""
    import contextlib
    import io
    import os
    import tempfile

    from lora_tpu_torch import PlanGateway
    from lora_tpu_torch import cli
    from lora_tpu_torch.stream import WidebandStreamingReceiver

    center, rate = PLAN_GEOMS["EU868"]
    gw = PlanGateway("EU868", center, rate, sfs=GATEWAY_SFS, pool=24, max_candidates=2,
                     max_symbols=24, sfd_search=12, demod_method="fft")
    def make():
        return WidebandStreamingReceiver(gw, block_symbols=64, max_in_flight=2)

    sr = make()
    sr.close()
    check((sr.hop, sr.block_len) == (4_194_304, 7_536_728),
          f"plan stream geometry {sr.hop}, {sr.block_len}")
    x, placements = plan_stream_capture(gw, STREAM_BLOCKS * sr.hop, sr.hop)
    sps_of = {sf: rx.sps for sf, rx in gw.rxs.items()}.get
    frames, wall = run_stream(make, x, "(c) plan EU868", {"fused_chan": 1, "lag_rows": 1})
    oneshot = gw.run(x)
    stream_vs_oneshot(frames, oneshot, "(c) plan EU868", sps_of)
    in_oneshot = {(f.tap_header.sf, f.channel, f.payload) for f in oneshot}

    def drift_fault(f):
        return (gw.rxs[f.tap_header.sf].fft_drift_pass and f.crc_ok is False
                and (f.tap_header.sf, f.channel, f.payload) in in_oneshot)

    stream_gate(frames, placements, "(c) plan EU868", sps_of, fault=drift_fault)
    rate_c = len(x) / wall
    print(f"stream (c) plan EU868: {rate_c / 1e6:.2f} Msamples/s, "
          f"{wall * 1e3 / (len(x) / sr.hop):.2f} ms a hop of {sr.hop} samples, on {smi_line}")
    ring_and_copy_rates(sr.block_len, smi_line)
    def streamed_once():
        s = make()
        stream_push(s, x)
        s.close()

    # the profiler can drop a block's events: the most complete of three
    # traced runs is kept, and the busy time taken a traced block
    _, rows, _ = device_rows(streamed_once)
    blocks = len(x) // sr.hop + 1
    traced = min(sum(c for name, _, c in rows if k in name) for k in ("fused_chan", "lag_rows"))
    check(traced > 0, "(c): the profiler traced no block of the streamed run")
    busy = sum(r[1] for r in rows) / traced
    copies = sum(r[1] for r in rows if "memcpy" in r[0].lower()) / traced
    print(f"stream (c) plan EU868: device busy {busy:.3f} ms a streamed block (copies "
          f"{copies:.3f} ms; {traced} of {blocks} blocks traced), {blocks} blocks in "
          f"{wall * 1e3:.1f} ms unprofiled: device idle {100 * (1 - busy * blocks / (wall * 1e3)):.1f} % of the "
          f"streamed run, on {smi_line}")
    for key, ms, count in rows[:8]:
        print(f"  {ms:8.3f} ms x{count:<5d} {key[:90]}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "eu868.cf32")
        x.tofile(path)
        out = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["gateway", path, "--plan", "EU868", "--center-freq", str(center),
                           "--samp-rate", str(rate), "--pool", "24", "--stream",
                           "--block-symbols", "96"])
        n = counts()
    lines = out.getvalue().strip().splitlines()
    want = sorted(f"ch{f.channel} sf{f.tap_header.sf} {f.tap_header.frequency}Hz "
                  + " ".join(f"{b:02x}" for b in f.to_bytes(1)) for f in frames)
    print(f"stream (d) cli gateway --plan EU868 --stream: rc {rc}, {len(lines)} frame lines, "
          f"launches {n}")
    check(rc == 0, f"(d): exit code {rc}")
    check(n["fused_chan"] >= 3 and n["fused_chan"] == n["lag_rows"]
          and n["det_metrics"] == n["pfb_fir"] == 0, f"(d): launches {n}")
    check(sorted(lines) == want, f"(d): the command's lines differ from (c)'s frames: "
          f"{sorted(set(lines) ^ set(want))[:4]}")
    return rate_c, (x, frames)


# ------------------------------------------ the facade, suites, modes
FACADE_CENTER = 868.1e6
FACADE_OFFSETS = (-300e3, 0.0, 250e3)   # channels, Hz from the capture's center
SMOKE_SUITES = ("short_sim", "short_sim_implicit", "short_sim_sdr")


def equal_frames(fg, fc, label: str) -> None:
    """Frames on the card against the CPU's: header bytes, payload,
    channel, sample index and frequency equal; cfo within 2 Hz, snr
    within 1e-4 of the CPU's (float32 sums in another order)."""
    check(len(fg) == len(fc), f"{label}: {len(fg)} frames on the card, {len(fc)} on the CPU")
    for a, b in zip(fg, fc):
        check((a.phy_header.to_bytes(), a.payload, a.channel, a.sample_index,
               a.tap_header.frequency)
              == (b.phy_header.to_bytes(), b.payload, b.channel, b.sample_index,
                  b.tap_header.frequency),
              f"{label}: frame differs from the CPU's")
        check(abs(a.cfo - b.cfo) <= 2.0, f"{label}: cfo differs from the CPU's")
        check(abs(a.snr - b.snr) <= 1e-4 * abs(b.snr), f"{label}: snr differs")


def facade_capture(seed: int = 21):
    """A 1 Msps capture of 2^21 samples around ``FACADE_CENTER``: six SF7
    CR4/8 packets on each channel of ``FACADE_OFFSETS`` (payload ``f0+c,
    k, de ad be ef``), staggered, over noise of 0.02 a part: ~40 dB in a
    channel, above the other channels' leakage through the 53 dB channel
    filter (a scale-invariant detector raises candidates on any chirp
    above the noise). Returns ``(x, {channel: payloads})``."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    L = 1 << 21
    rng = np.random.default_rng(seed)
    x = (0.02 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    want = {}
    for c, off in enumerate(FACADE_OFFSETS):
        want[c] = []
        for k in range(6):
            payload = bytes([0xF0 + c, k]) + DEADBEEF
            pkt = modulate_frame(cfg, payload, snr_db=None, seed=10 * c + k)
            pos = 20_000 + k * 330_000 + c * 97_000
            t = np.arange(pos, pos + len(pkt), dtype=np.float64)
            x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * off / 1e6 * t)).astype(
                np.complex64)
            want[c].append(payload)
    return x, want


def phase_facade(smi_line):
    """``LoRaReceiver(engine="dense")`` on the card at SF7 CR4/8, 1 Msps
    (the gradient engine): one channel (``freq_xlating_fir``) and three
    (``channelize_list``) of :func:`facade_capture`; every packet of its
    channels decoded and no other frame, the frames equal to the same
    facade's on the CPU, one K1 launch a ``receive()`` (counts zeroed just
    before, read just after); K1 at the facade's planes against its plain
    version; the median ``receive()``. Returns ``{channels: launches}``."""
    import numpy as np
    import torch

    from lora_tpu_torch import LoRaReceiver
    from lora_tpu_torch.channelizer import channelize_list
    from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                                 detection_metrics_planes)

    x, want = facade_capture()
    out = {}
    for n_ch in (1, 3):
        kw = dict(samp_rate=1e6, center_freq=FACADE_CENTER,
                  channel_list=[FACADE_CENTER + o for o in FACADE_OFFSETS[:n_ch]],
                  bandwidth=125e3, sf=7, cr=4, crc=True, engine="dense",
                  max_candidates=8, max_symbols=24)
        rx = LoRaReceiver(**kw)
        check(rx.device.type == "cuda", "the facade did not default to the card")
        rx.receive(x)                                   # tables moved, warm
        torch.cuda.synchronize()
        zero_counts()
        frames = rx.receive(x)
        torch.cuda.synchronize()
        n = counts()
        label = f"facade {n_ch} channel{'s' if n_ch > 1 else ''}"
        check(rx._decoders.method == "gradient", f"{label}: engine {rx._decoders.method}")
        check(n == {"det_metrics": 1, "pfb_fir": 0, "lag_rows": 0, "fused_chan": 0},
              f"{label}: launches {n}, want one det_metrics a receive()")
        got = sorted((f.channel, f.mac_payload) for f in frames)
        check(got == sorted((c, p) for c in range(n_ch) for p in want[c]),
              f"{label}: frames {got}")
        check(all(f.crc_ok and f.tap_header.frequency == int(kw["channel_list"][f.channel])
                  for f in frames), f"{label}: CRC or tap header")
        equal_frames(frames, LoRaReceiver(device="cpu", **kw).receive(x), label)
        ms = call_ms(lambda: rx.receive(x), 5)
        print(f"{label}: {len(frames)}/{6 * n_ch} packets, launches {n}, frames equal to "
              f"the CPU's; receive() median {float(np.median(ms)):.3f} ms "
              f"({[round(v, 3) for v in ms]}; {x.size} samples; {smi_line})")
        out[n_ch] = n
    # K1 at the three-channel facade's planes: the channel streams,
    # padded by the packet region as process() pads them
    dec = rx._decoders
    streams = channelize_list(x, rx._taps, list(FACADE_OFFSETS), 1e6, 1, device="cuda")
    xf = dec._planes_of(streams).contiguous()
    got = detection_metrics_kernel(xf, dec.sps)
    ref = detection_metrics_planes(xf, dec.sps)
    err = float((got[0] - ref[0]).abs().max())
    check(err <= TOL_CORR_ATOL, f"facade K1 corr err {err}")
    for g, r in zip(got[1:], ref[1:]):
        check(bool(torch.allclose(g, r, rtol=TOL_ENER_RTOL, atol=0)), "facade K1 energies")
    print(f"facade: det_metrics at {list(xf.shape)} against its plain version: corr "
          f"max abs err {err:.3g}")
    return out


def phase_suites(smi_line):
    """``SMOKE_SUITES`` (72 traces, 384 packets each, SF7-12 at 1 Msps)
    from the port's generator into ``.suites/`` beside this script, run by
    the port's ``run_suite(engine="dense")`` on the card, each deleted
    after it ran: each must reach 384/384."""
    import os

    from lora_tpu_torch.tools.suite_matrix import MATRIX, run_one

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".suites", "smoke")
    os.makedirs(work, exist_ok=True)
    gen_kw = dict(MATRIX)
    for suite in SMOKE_SUITES:
        row = run_one(suite, work, None, "dense", "cuda", **gen_kw[suite])
        print(f"suite {suite}: {row['passed']}/{row['total']} generate {row['gen_s']} s, "
              f"decode {row['decode_s']} s ({smi_line})")
        check(row["passed"] == row["total"] == 384, f"suite {suite}: {row}")
    os.rmdir(work)


def low_snr_captures(kw, snr_db: float, n: int):
    """tests/test_low_snr.py's captures: one deadbeef packet each, at
    ``snr_db``."""
    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    cfg = LoRaConfig(**kw)
    sps = cfg.samples_per_symbol
    return [modulate_frame(cfg, DEADBEEF, pad_before=2500 + 137 * k, pad_after=3 * sps,
                           snr_db=snr_db, seed=k) for k in range(n)]


def phase_low_snr(smi_line):
    """The coherent mode on the card: ``DenseReceiver(low_snr=True)`` at
    SF7 / 250 ksps, -4 dB (6 packets), and at SF12 / 250 ksps, -16 dB (4
    packets: the 64M fold budget, two 32M-entry matrices), every packet
    decoded with no K1 launch (the dechirp metric is a plain product),
    frames equal to the CPU's (SF7 all, SF12 the first); then the facade's
    ``low_snr="auto"`` on a weak capture: the second pass is built and
    decodes it, as on the CPU."""
    import time

    import torch

    from lora_tpu_torch import DenseReceiver, LoRaConfig, LoRaReceiver

    rx_kw = dict(max_candidates=8, max_symbols=24, sfd_search=12, low_snr=True)
    for kw, snr, n, n_cpu in ((dict(sf=7, cr=4, samp_rate=250e3, crc=True), -4.0, 6, 6),
                              (dict(sf=12, cr=4, samp_rate=250e3, crc=True,
                                    reduced_rate=True), -16.0, 4, 1)):
        t0 = time.perf_counter()
        rx = DenseReceiver(LoRaConfig(**kw), **rx_kw)
        t_build = time.perf_counter() - t0
        entries = rx._fold_mat[0].numel()
        xs = low_snr_captures(kw, snr, n)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        frames = [rx.run(x) for x in xs]
        t_run = time.perf_counter() - t0
        n_k = counts()
        ok = sum(any(f.mac_payload == DEADBEEF for f in fs) for fs in frames)
        label = f"low_snr SF{kw['sf']} at {snr} dB"
        check(ok == n, f"{label}: {ok}/{n} decoded")
        check(n_k["det_metrics"] == 0, f"{label}: K1 launched {n_k}")
        cpu = DenseReceiver(LoRaConfig(**kw), **rx_kw, device="cpu")
        for k in range(n_cpu):
            equal_frames(frames[k], cpu.run(xs[k]), f"{label} capture {k}")
        print(f"{label}: {ok}/{n} decoded; fold matrices {entries} entries each, built in "
              f"{t_build:.2f} s; {n} run() {t_run:.3f} s; {n_cpu} equal to the CPU's "
              f"({smi_line})")
    kw = dict(samp_rate=250e3, center_freq=FACADE_CENTER, channel_list=[FACADE_CENTER],
              bandwidth=125e3, sf=7, cr=4, crc=True, engine="dense",
              disable_channelization=True, low_snr="auto", max_candidates=8,
              max_symbols=24, sfd_search=12)
    x = low_snr_captures(dict(sf=7, cr=4, samp_rate=250e3, crc=True), -4.0, 3)[2]
    fac = LoRaReceiver(**kw)
    frames = fac.receive(x)
    check(fac._coherent not in (None, False) and fac._coherent.device.type == "cuda",
          "low_snr auto: the coherent pass was not built on the card")
    check([f.mac_payload for f in frames] == [DEADBEEF], "low_snr auto: not decoded")
    equal_frames(frames, LoRaReceiver(device="cpu", **kw).receive(x), "low_snr auto")
    print("low_snr auto: the parity gates found nothing, the coherent pass decoded "
          "the capture, equal to the CPU's")


def trace_close(got: dict, want: dict, label: str) -> None:
    """debug_trace on the card against the CPU: the same keys, shapes and
    dtypes; integer and boolean keys equal; float keys within rtol 1e-5,
    atol 1e-6 of the key's largest magnitude (the CPU tests' tolerance),
    the K1 metric ``corr`` within its kernel's ``TOL_CORR_ATOL``."""
    import numpy as np

    check(sorted(got) == sorted(want), f"{label}: keys differ")
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape and g.dtype == w.dtype, f"{label}: {k} shape/dtype")
        if np.issubdtype(w.dtype, np.floating):
            atol = TOL_CORR_ATOL if k == "corr" else 1e-6 * float(np.abs(w).max())
            check(bool(np.allclose(g, w, rtol=1e-5, atol=atol)),
                  f"{label}: {k} max diff {float(np.abs(g - w).max())}")
        else:
            check(bool(np.array_equal(g, w)), f"{label}: {k} differs")


def phase_implicit_debug():
    """Implicit headers on both engines (SF7, CR 4/5-4/8: the fft engine at
    250 ksps, the gradient engine at 1 Msps), every packet decoded, frames
    equal to the CPU's; ``debug_trace`` of both engines on the card
    against the CPU (:func:`trace_close`), one K1 launch a trace."""
    import torch

    from lora_tpu_torch import DenseReceiver, LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    payload = bytes.fromhex("cafe0102")
    rx_kw = dict(max_candidates=2, max_symbols=24, sfd_search=12)
    for method, rate in (("fft", 250e3), ("gradient", 1e6)):
        for cr in (1, 2, 3, 4):
            kw = dict(sf=7, cr=cr, samp_rate=rate, crc=False, implicit=True)
            cfg = LoRaConfig(**kw)
            sps = cfg.samples_per_symbol
            x = modulate_frame(cfg, payload, pad_before=4 * sps, pad_after=8 * sps,
                               snr_db=40.0, seed=cr)
            frames = DenseReceiver(cfg, demod_method=method, **rx_kw).run(x)
            label = f"implicit {method} CR 4/{4 + cr}"
            check(len(frames) == 1 and frames[0].payload[:4] == payload
                  and not any(frames[0].payload[4:]), f"{label}: {frames}")
            equal_frames(frames, DenseReceiver(cfg, demod_method=method, **rx_kw,
                                               device="cpu").run(x), label)
        print(f"implicit {method}: CR 4/5-4/8 decoded, equal to the CPU's")
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    x = modulate_frame(cfg, DEADBEEF, pad_before=3000, pad_after=2 * cfg.samples_per_symbol,
                       snr_db=30.0, seed=5)
    for method in ("gradient", "fft"):
        rx = DenseReceiver(cfg, demod_method=method, max_candidates=2, max_symbols=24)
        torch.cuda.synchronize()
        zero_counts()
        d = rx.debug_trace(x)
        n = counts()
        check(n["det_metrics"] == 1, f"debug_trace {method}: launches {n}")
        check(bool(d["ok"].any()), f"debug_trace {method}: nothing decoded")
        trace_close(d, DenseReceiver(cfg, demod_method=method, max_candidates=2,
                                     max_symbols=24, device="cpu").debug_trace(x),
                    f"debug_trace {method}")
        print(f"debug_trace {method}: {len(d)} keys equal to the CPU's (floats within "
              f"tolerance), one det_metrics launch")


# --------------------------------------------------- the parity engine
def loop_syncs(syncs) -> int:
    """The host synchronisations reported in the parity engine's module."""
    return sum("rx/receiver.py" in s.replace("\\", "/") for s in syncs)


def clamp_capture(cfg, n_noise_symbols: int = 700):
    """tests/test_torch_parity.py's clamp case: an implicit SF7 frame, then
    noise of the signal's power to the end of the stream, so the payload
    demod appends past the demod buffer's 544 codewords."""
    import numpy as np

    from lora_tpu_torch.tx.modulator import modulate_frame

    pkt = modulate_frame(cfg, DEADBEEF, pad_before=2500, snr_db=None, seed=0)
    rng = np.random.default_rng(0)
    L = n_noise_symbols * cfg.samples_per_symbol
    return np.concatenate([pkt, (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(
        np.complex64)])


def phase_parity(smi_line):
    """The parity engine on the card: ``LoRaReceiver(engine="parity")`` on
    :func:`facade_capture`, one channel and three (one batched loop), every
    packet decoded (6/6, 18/18), the frames equal to the port's golden
    facade's and to the parity facade's on the CPU (header, payload,
    channel and sample index exact, snr within 1e-4 relative); the loop's
    steps, its host syncs a step (at most one: the state read; the ring's
    fetch once a call), its device kernels and copies a step (profiled) and
    the median ``receive()``. Then ``short_sim`` through
    ``run_suite(engine="parity")`` (384/384), the clamp case's final state
    against the CPU's, and the SF13 sliding sync (sps 65,536) against the
    CPU's with the device memory it took."""
    import collections

    import numpy as np
    import torch

    from lora_tpu_torch import LoRaConfig, LoRaReceiver, ParityReceiver
    from lora_tpu_torch.device import full_f32_matmul
    from lora_tpu_torch.ops import demod
    from lora_tpu_torch.ops.chirp import build_ideal_chirps, instantaneous_frequency_np

    x, want = facade_capture()
    out = {}
    for n_ch in (1, 3):
        kw = dict(samp_rate=1e6, center_freq=FACADE_CENTER,
                  channel_list=[FACADE_CENTER + o for o in FACADE_OFFSETS[:n_ch]],
                  bandwidth=125e3, sf=7, cr=4, crc=True)
        label = f"parity facade {n_ch} channel{'s' if n_ch > 1 else ''}"
        rx = LoRaReceiver(engine="parity", **kw)
        check(rx.device.type == "cuda", f"{label}: not on the card")
        rx._decoders = rx._make_decoder()       # its tables on the card: set-up
        torch.cuda.synchronize()
        zero_counts()
        syncs = host_syncs_in(lambda: out.__setitem__("frames", rx.receive(x)))
        frames = out["frames"]
        dec = rx._decoders
        check(isinstance(dec, ParityReceiver) and dec.device.type == "cuda",
              f"{label}: engine {type(dec)}")
        steps, reads = dec.steps, dec.state_reads
        got = sorted((f.channel, f.mac_payload) for f in frames)
        check(got == sorted((c, p) for c in range(n_ch) for p in want[c]),
              f"{label}: frames {got}")
        in_loop = loop_syncs(syncs)
        check(reads == steps + 1 and in_loop <= reads + 1,
              f"{label}: {in_loop} host syncs in the engine for {steps} steps ({reads} "
              f"reads): {collections.Counter(syncs).most_common(8)}")
        t0 = time.perf_counter()
        equal_frames(frames, LoRaReceiver(engine="golden", device="cpu", **kw).receive(x),
                     f"{label} vs golden")
        t1 = time.perf_counter()
        equal_frames(frames, LoRaReceiver(engine="parity", device="cpu", **kw).receive(x),
                     f"{label} vs the CPU")
        t2 = time.perf_counter()
        ms = call_ms(lambda: rx.receive(x), 3)
        # device kernels and copies a step, profiled on the capture's first
        # 2^18 samples (~256 steps: the whole capture's ~2,050 steps make
        # the profiler's own cost dominate)
        head = x[:1 << 18]
        _, rows, _ = device_rows(lambda: rx.receive(head), tries=1)
        head_steps = dec.steps
        launches = sum(r[2] for r in rows)
        print(f"{label}: {len(frames)}/{6 * n_ch} packets, equal to the golden facade's and "
              f"the CPU's; {steps} steps; host syncs {len(syncs)} in receive(), {in_loop} in "
              f"the engine ({in_loop / steps:.4f} a step); device kernels and copies "
              f"{launches / head_steps:.1f} a step ({launches} in {head_steps} steps of the "
              f"first 2^18 samples); receive() median {float(np.median(ms)):.3f} ms "
              f"({[round(v, 3) for v in ms]}; {float(np.median(ms)) / steps:.4f} ms a step; "
              f"{smi_line}); the CPU's golden facade {t1 - t0:.1f} s, parity {t2 - t1:.1f} s")
        for name, t, c in rows[:6]:
            print(f"  {t:8.3f} ms x{c:<6d} {name[:90]}")
        out[n_ch] = dict(steps=steps, syncs_per_step=in_loop / steps,
                         launches_per_step=launches / head_steps, ms=float(np.median(ms)))
        stamp(f"parity facade {n_ch}")

    # short_sim through the suite runner on the parity engine
    import os

    from lora_tpu_torch.tools.suite_matrix import MATRIX, run_one

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".suites", "smoke")
    os.makedirs(work, exist_ok=True)
    row = run_one("short_sim", work, None, "parity", "cuda", **dict(MATRIX)["short_sim"])
    print(f"suite short_sim (parity): {row['passed']}/{row['total']} generate {row['gen_s']} "
          f"s, decode {row['decode_s']} s ({smi_line})")
    check(row["passed"] == row["total"] == 384, f"suite short_sim (parity): {row}")
    os.rmdir(work)
    stamp("parity short_sim")

    # the clamp case: the loop ends in DECODE_PAYLOAD with a full buffer
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True, implicit=True)
    xc = torch.from_numpy(clamp_capture(cfg))[None]
    states = [r.process_complex(xc.to(r.device))
              for r in (ParityReceiver(cfg), ParityReceiver(cfg, device="cpu"))]
    for k, w in states[1].items():
        g = states[0][k].cpu()
        ok = (torch.allclose(g, w, rtol=1e-4, atol=0) if w.is_floating_point()
              else torch.equal(g, w))
        check(ok, f"clamp case: {k} differs from the CPU's")
    check(int(states[0]["n_demod"][0]) == 544 and int(states[0]["demod_buf"][0, -1]) != 0,
          "clamp case: the buffer did not fill")
    print("parity clamp case: the final state (demod buffer full, its clamped last slot "
          "included) equal to the CPU's")

    # SF13 at 1 Msps: the O(sps^2) sliding sync on one [2*65536] window
    cfg13 = LoRaConfig(sf=13, cr=4, samp_rate=1e6, crc=True, reduced_rate=True)
    sps = cfg13.samples_per_symbol
    up, _ = build_ideal_chirps(cfg13)
    ifr = torch.as_tensor(instantaneous_frequency_np(up))
    w2 = torch.as_tensor(np.concatenate([up[sps // 3:], up, up[:sps // 3]])[None])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with full_f32_matmul():
        got = demod.upchirp_sync_xcorr(w2.cuda(), ifr.cuda(), sps)
        ms13 = cuda_ms(lambda: demod.upchirp_sync_xcorr(w2.cuda(), ifr.cuda(), sps), 3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    ref = demod.upchirp_sync_xcorr(w2, ifr, sps)
    check(int(got[0][0]) == int(ref[0][0]), f"SF13 sync: {int(got[0][0])} vs the CPU's "
          f"{int(ref[0][0])}")
    print(f"parity SF13 sliding sync at sps {sps}: offset {int(got[0][0])} as on the CPU, "
          f"{ms13:.3f} ms a window, {peak:.1f} MiB of device memory above the inputs "
          f"({smi_line})")
    return out


# ------------------------------------------------------- the flowgraphs
def same_placed(frames, ref, label: str, sps: int) -> int:
    """The same channels, PHY headers and payloads as ``ref``'s frames,
    each sample index within one symbol (``sps``) of its counterpart's (a
    streamer reports a packet whose rising edge falls on a block's first
    window a window later, as JAX's does). Returns how many moved."""
    def keyed(fs):
        return sorted(((f.channel, f.phy_header.to_bytes(), f.payload), f.sample_index)
                      for f in fs)

    a, b = keyed(frames), keyed(ref)
    check([k for k, _ in a] == [k for k, _ in b], f"{label}: frames differ: "
          f"{sorted(set(k for k, _ in a) ^ set(k for k, _ in b))[:4]}")
    moved = [ia - ib for (_, ia), (_, ib) in zip(a, b) if ia != ib]
    check(all(abs(m) <= sps for m in moved), f"{label}: sample indices moved by {moved}")
    return len(moved)


def write_graph(path, blocks, connections, variables=None) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"options": {"id": "smoke"}, "variables": variables or {},
                        "blocks": blocks, "connections": connections}, f, sort_keys=False)
    return str(path)


def pfb_grid_capture(M: int, rate: float, spacing_ks, seed: int = 9):
    """The geometry of tests/test_flowgraph_wideband.py at ``M`` channels:
    a packet on each channel ``k * rate / M`` of ``spacing_ks`` (one
    negative), SF7 at the channel rate, over noise of 1e-4 a part.
    Returns ``(x, {channel index: payload}, length)``."""
    import numpy as np

    from lora_tpu_torch import LoRaConfig
    from lora_tpu_torch.tx.modulator import modulate_frame

    wide = LoRaConfig(sf=7, cr=4, samp_rate=rate, crc=True)
    sps_w = wide.samples_per_symbol
    pkts = {ci: modulate_frame(wide, bytes([0xC0 + ci]) + DEADBEEF, snr_db=None, seed=ci)
            for ci in range(len(spacing_ks))}
    L = (4 + 20 * len(spacing_ks)) * sps_w + max(len(p) for p in pkts.values()) + 64 * sps_w
    rng = np.random.default_rng(seed)
    x = (1e-4 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    for ci, k in enumerate(spacing_ks):
        pkt = pkts[ci]
        pos = (4 + 20 * ci) * sps_w
        t = np.arange(pos, pos + len(pkt), dtype=np.float64)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (k / M) * t)).astype(np.complex64)
    return x, {ci: bytes([0xC0 + ci]) + DEADBEEF for ci in range(len(spacing_ks))}


def phase_flowgraph(smi_line, plan_stream):
    """YAML graphs written to a temporary directory and run on the card
    (``run_flowgraph`` or the ``flowgraph`` command), each with the counts
    zeroed just before it and read just after: (1) the off-grid route, the
    facade capture's three channels at decimation 1 (the card's mixer bank,
    the dense engine in the streamers): 18/18, the payloads, channels and
    sample indices of the facade's dense frames, the file sink's bytes the
    frames' LoRaTap bytes; (2) the PFB-grid route at M = 64, 16 Msps (250
    ksps a channel), 8 active channels, one at a negative offset: every
    placement decoded, one pfb_fir and one det_metrics launch a block; (3)
    ``lora_gateway`` with ``plan: EU868`` on stream (c)'s capture: its
    frames, the reference's SF11 drift-pass fault included as (c) has it;
    (4) one channel on the parity and golden engines: equal frames; (5) a
    message-only graph, ``message_socket_source`` to
    ``message_file_sink`` on 127.0.0.1; (6) ``blocks`` (12 descriptors)
    and ``analyze --max-buffers 2`` against a ``SampleDebugger``. Returns
    the graphs' launch counts."""
    import contextlib
    import io
    import os
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    from lora_tpu_torch import Flowgraph, LoRaReceiver, cli, run_flowgraph
    from lora_tpu_torch.debugger import SampleDebugger

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the off-grid route
        x, want = facade_capture()
        cap = os.path.join(tmp, "facade.cf32")
        x.tofile(cap)
        sink = os.path.join(tmp, "frames.bin")
        chans = [FACADE_CENTER + o for o in FACADE_OFFSETS]
        g = write_graph(os.path.join(tmp, "offgrid.yml"), [
            {"name": "src", "id": "file_source", "parameters": {"file": cap}},
            {"name": "rx", "id": "lora_receiver",
             "parameters": {"samp_rate": "samp_rate", "center_freq": "capture_freq",
                            "channel_list": chans, "bandwidth": 125000, "sf": 7, "cr": 4,
                            "crc": True, "implicit": False}},
            {"name": "file", "id": "message_file_sink", "parameters": {"file": sink}},
        ], [["src", "0", "rx", "0"], ["rx", "frames", "file", "in"]],
            {"samp_rate": 1e6, "capture_freq": FACADE_CENTER})
        graph = Flowgraph.from_yaml(g)
        check(graph.blocks["rx"].route == "mixer_bank", "(1): not the mixer-bank route")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        frames = graph.run()
        wall = time.perf_counter() - t0
        launches["offgrid"] = n = counts()
        got = sorted((f.channel, f.mac_payload) for f in frames)
        check(got == sorted((c, p) for c in range(3) for p in want[c]), f"(1): frames {got}")
        dense = LoRaReceiver(samp_rate=1e6, center_freq=FACADE_CENTER, channel_list=chans,
                             bandwidth=125e3, sf=7, cr=4, crc=True, engine="dense").receive(x)
        moved = same_placed(frames, dense, "(1)", 1024)
        with open(sink, "rb") as f:
            check(f.read() == b"".join(fr.to_bytes(0) for fr in frames),
                  "(1): the file sink's bytes are not the frames'")
        check(n["det_metrics"] > 0 and n["pfb_fir"] == n["lag_rows"] == n["fused_chan"] == 0,
              f"(1): launches {n}")
        print(f"flowgraph (1) off-grid, 3 channels at decimation 1 (mixer bank): "
              f"{len(frames)}/18, equal to the facade's dense frames ({moved} sample indices "
              f"moved, each within a symbol), file sink bytes equal; "
              f"launches {n}; {wall:.2f} s for {x.size} samples ({smi_line})")

        # (2) the PFB-grid route: M = 64 at 16 Msps, 8 active channels
        M, rate = 64, 16e6
        ks = (1, 5, -2, 9, 17, -23, 30, -31)
        xg, pwant = pfb_grid_capture(M, rate, ks)
        capg = os.path.join(tmp, "grid.cf32")
        xg.tofile(capg)
        center = 868.0e6
        g = write_graph(os.path.join(tmp, "grid.yml"), [
            {"name": "src", "id": "file_source",
             "parameters": {"file": capg, "chunk_samples": 1 << 20}},
            {"name": "rx", "id": "lora_receiver",
             "parameters": {"samp_rate": rate, "center_freq": center,
                            "channel_list": [center + k * rate / M for k in ks],
                            "sf": 7, "cr": 4, "crc": True, "decimation": M,
                            "block_symbols": 128, "max_candidates": 2, "max_symbols": 24}},
        ], [["src", "0", "rx", "0"]])
        graph = Flowgraph.from_yaml(g)
        rxb = graph.blocks["rx"]
        check(rxb.route == "pfb", "(2): not the PFB route")
        blocks = []
        inner = rxb._wb_stream._process
        rxb._wb_stream._process = lambda planes: (blocks.append(1), inner(planes))[1]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        frames = graph.run()
        wall = time.perf_counter() - t0
        launches["pfb"] = n = counts()
        got = {f.channel: f.payload[:len(pwant[f.channel])] for f in frames}
        check(got == pwant, f"(2): frames {sorted(got.items())}")
        check(all(f.tap_header.frequency == int(center + ks[f.channel] * rate / M)
                  for f in frames), "(2): tap header frequency")
        check(n["pfb_fir"] == n["det_metrics"] == len(blocks) > 0
              and n["lag_rows"] == n["fused_chan"] == 0,
              f"(2): launches {n} for {len(blocks)} blocks")
        print(f"flowgraph (2) PFB grid M={M} at {rate / 1e6:.0f} Msps, {len(ks)} channels: "
              f"{len(frames)}/{len(ks)} decoded; {len(blocks)} blocks, launches {n}; "
              f"{wall:.2f} s for {xg.size} samples ({smi_line})")

        # (3) the plan gateway on stream (c)'s capture
        xp, cframes = plan_stream
        capp = os.path.join(tmp, "eu868.cf32")
        xp.tofile(capp)
        pc, prate = PLAN_GEOMS["EU868"]
        g = write_graph(os.path.join(tmp, "plan.yml"), [
            {"name": "src", "id": "file_source", "parameters": {"file": capp}},
            {"name": "gw", "id": "lora_gateway",
             "parameters": {"samp_rate": prate, "center_freq": pc, "plan": "EU868",
                            "sfs": list(GATEWAY_SFS), "pool": 24, "block_symbols": 96}},
        ], [["src", "0", "gw", "0"]])
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        frames = run_flowgraph(g)
        wall = time.perf_counter() - t0
        launches["plan"] = n = counts()
        stream_vs_oneshot(frames, cframes, "flowgraph (3) vs (c)", lambda sf: 2 ** sf * 2)
        check(n["fused_chan"] >= 3 and n["fused_chan"] == n["lag_rows"]
              and n["det_metrics"] == n["pfb_fir"] == 0, f"(3): launches {n}")
        faults = sum(f.crc_ok is False for f in frames)
        print(f"flowgraph (3) lora_gateway plan EU868: {len(frames)} frames, equal to stream "
              f"(c)'s ({faults} with a failed CRC, the reference's SF11 drift-pass fault as "
              f"(c) has it); launches {n}; {wall:.2f} s ({smi_line})")

        # (4) one channel on the buffered engines
        res = {}
        for engine in ("parity", "golden"):
            g = write_graph(os.path.join(tmp, f"{engine}.yml"), [
                {"name": "src", "id": "file_source", "parameters": {"file": cap}},
                {"name": "rx", "id": "lora_receiver",
                 "parameters": {"samp_rate": 1e6, "center_freq": FACADE_CENTER,
                                "channel_list": [chans[0]], "sf": 7,
                                "engine": repr(engine)}},
            ], [["src", "0", "rx", "0"]])
            out = io.StringIO()
            with contextlib.redirect_stderr(out):
                check(cli.main(["flowgraph", g]) == 0, f"(4) {engine}: exit code")
            res[engine] = run_flowgraph(g)
            check(out.getvalue().strip().endswith(f"decoded {len(res[engine])} frames"),
                  f"(4) {engine}: {out.getvalue()!r}")
        check(sorted(f.mac_payload for f in res["parity"]) == sorted(want[0]),
              f"(4): parity frames {[f.mac_payload for f in res['parity']]}")
        equal_frames(res["parity"], res["golden"], "(4) parity vs golden")
        print(f"flowgraph (4) one channel (the card's FIR): parity {len(res['parity'])}/6 "
              f"frames, equal to golden's")

        # (5) a message-only graph on 127.0.0.1
        msink = os.path.join(tmp, "msg.bin")
        graph = Flowgraph({"blocks": [
            {"name": "src", "id": "message_socket_source",
             "parameters": {"addr": "127.0.0.1", "port": 0}},
            {"name": "file", "id": "message_file_sink", "parameters": {"file": msink}},
        ], "connections": [["src", "out", "file", "in"]]})
        port = graph.blocks["src"].port
        datagrams = [f.to_bytes(0) for f in res["parity"][:3]]

        def send():
            time.sleep(0.2)
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for d in datagrams:
                s.sendto(d, ("127.0.0.1", port))
                time.sleep(0.02)
            s.close()

        t = threading.Thread(target=send)
        t.start()
        got = graph.run(max_frames=len(datagrams), max_seconds=20.0)
        t.join()
        with open(msink, "rb") as f:
            check(len(got) == len(datagrams) and f.read() == b"".join(datagrams),
                  "(5): the message graph's file differs from the datagrams")
        print(f"flowgraph (5) message_socket_source -> message_file_sink: {len(got)} "
              f"datagrams republished byte-equal")

        # (6) blocks and analyze
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli.main(["blocks"]) == 0, "(6) blocks: exit code")
        n_desc = out.getvalue().count("id: lora_")
        check(n_desc == 12, f"(6) blocks: {n_desc} descriptors")
        path = os.path.join(tmp, "scope.sock")

        def client():
            d = SampleDebugger()
            for _ in range(500):
                d.attach(path)
                if d.attached:
                    break
                time.sleep(0.02)
            for k in range(3):
                d.store_samples(x[k * 1000:(k + 1) * 1000])
                d.analyze_samples()
            d.detach()

        t = threading.Thread(target=client)
        t.start()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli.main(["analyze", "--socket", path, "--max-buffers", "2"]) == 0,
                  "(6) analyze: exit code")
        t.join()
        print(f"flowgraph (6) blocks: {n_desc} descriptors; analyze --max-buffers 2: "
              f"{out.getvalue().strip()!r}")
    return launches


# ------------------------------------------------------------- sharding
def sharded_frames(res, block: int, sf: int = 0) -> list:
    """Frames of a time-sharded result (every field with a leading shard
    axis, ``[n, P]`` or ``[n, C, P]``): each valid lane's ``sample_index``
    made global by its shard's offset ``shard * block``, its channel the
    lane's row (0 for one stream), ``tap_header.sf`` = ``sf``."""
    import numpy as np

    from lora_tpu_torch.io.frames import Frame, PhyHeader

    valid = res.valid.cpu().numpy()
    pay, plen = res.payload.cpu().numpy(), res.length.cpu().numpy()
    hdr, start = res.hdr.cpu().numpy(), res.start.cpu().numpy()
    snr, cfo = res.snr.cpu().numpy(), res.cfo.cpu().numpy()
    frames = []
    for idx in map(tuple, np.argwhere(valid)):
        f = Frame(phy_header=PhyHeader.from_bytes(bytes(hdr[idx])),
                  payload=bytes(pay[idx][: plen[idx]]), snr=float(snr[idx]),
                  channel=int(idx[1]) if valid.ndim == 3 else 0,
                  sample_index=idx[0] * block + int(start[idx]), cfo=float(cfo[idx]))
        f.tap_header.sf = sf
        frames.append(f)
    return frames


def same_results(got, want, label: str, exact: bool = False) -> None:
    """Two receiver results: every integer field bit-equal on every lane,
    the payloads on the valid lanes; ``snr`` rtol 1e-5 and ``cfo`` atol 1
    Hz on the valid lanes (the Phase B products may take other GEMM
    algorithms at another batch size); ``exact``: every field bit-equal."""
    import torch

    valid = want.valid
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label}: {f} {tuple(g.shape)} {g.dtype}, expected {tuple(w.shape)} {w.dtype}")
        if exact or f not in ("payload", "snr", "cfo"):
            ok = torch.equal(g, w)
        elif f == "payload":
            ok = torch.equal(g[valid], w[valid])
        else:
            tol = (1e-5 * w[valid].abs()) if f == "snr" else 1.0
            ok = bool(((g[valid] - w[valid]).abs() <= tol).all())
        check(ok, f"{label}: {f} differs")


def seam_second_claims(frames, placements, block: int, n: int, sps: int, span: int,
                       label: str):
    """Split off the second claims of the reference's time sharding: a
    packet whose preamble runs across a shard seam is claimed by the shard
    it starts in and again by the next, one window (``sps``) past the seam,
    where enough of its preamble remains to sync (JAX's sharded pipeline
    does the same: ``ROADMAP.md`` section 3,
    ``tests/test_torch_sharding.py``). A second claim is a frame at ``d *
    block + sps`` with the channel and payload of a placement that starts
    before seam ``d`` and runs across it (``span`` samples; the ring of
    ``n`` blocks is circular: seam 0 is the capture's end, which the last
    shard's halo continues from the capture's head), while another frame
    claims that placement at its own place (within 3 symbols, as
    ``stream_gate`` matches); each is printed as the known fault. Returns
    the other frames."""
    total = n * block

    def first_claim(f, p):
        return any(g is not f and g.channel == p[1] and abs(g.sample_index - p[2]) <= 3 * sps
                   and g.payload[:len(p[3])] == p[3] for g in frames)

    keep, second = [], []
    for f in frames:
        d, r = divmod(f.sample_index, block)
        hit = [p for p in placements if r == sps and p[1] == f.channel
               and 0 < (d * block - p[2]) % total < span and f.payload[:len(p[3])] == p[3]
               and first_claim(f, p)]
        (second if hit else keep).append((f, hit))
    for f, hit in second:
        print(f"{label}: KNOWN REFERENCE FAULT (ROADMAP.md section 3, time sharding): the "
              f"packet placed at {hit[0][2]} on channel {f.channel} runs across the seam at "
              f"{f.sample_index - sps} and is claimed again there, {f.payload.hex()}")
    check(len({(f.channel, f.sample_index) for f, _ in second}) == len(second),
          f"{label}: a seam claimed twice on one channel")
    return [f for f, _ in keep]


def pfb_launches_by_m(by_m: dict):
    """A context in which every ``PolyphaseChannelizer.planes`` call adds
    the ``pfb_fir`` launches it made to ``by_m[its M]``: a call's K4 count
    split by filterbank, read from the wrapper's own count."""
    import contextlib

    from lora_tpu_torch.channelizer import PolyphaseChannelizer

    planes = PolyphaseChannelizer.planes

    def counted(self, *args, **kwargs):
        before = counts(("pfb_fir",))["pfb_fir"]
        try:
            return planes(self, *args, **kwargs)
        finally:
            by_m[self.M] = by_m.get(self.M, 0) + counts(("pfb_fir",))["pfb_fir"] - before

    @contextlib.contextmanager
    def split():
        PolyphaseChannelizer.planes = counted
        try:
            yield by_m
        finally:
            PolyphaseChannelizer.planes = planes

    return split()


def run_sharded(fn, x, label: str, want: dict, during=None):
    """One call of the sharded ``fn(x)`` with every count zeroed just
    before it and read just after (``want``: the launches it must make;
    ``during``: a context around this call alone), then three timed calls
    (wall ms between two synchronisations). Returns ``(result, launches,
    median ms)``."""
    import contextlib
    import statistics

    import torch

    torch.cuda.synchronize()
    zero_counts()
    with during or contextlib.nullcontext():
        res = fn(x)
    torch.cuda.synchronize()
    n = counts()
    expect = {k: want.get(k, 0) for k in n}
    ms = call_ms(lambda: fn(x), 3)
    print(f"sharding {label}: launches {n}; wall {statistics.median(ms):.3f} ms (median of "
          f"3: {', '.join(f'{t:.3f}' for t in ms)})")
    check(n == expect, f"{label}: expected launches {expect}, got {n}")
    return res, n, statistics.median(ms)


def subband_10k_capture(n_dev: int, M_fine: int, cfg, L: int, chans, seed: int = 11):
    """``__graft_entry__._dryrun_subband_10k``'s capture at ``n_dev *
    M_fine`` fine channels, built on the card: ``L`` samples of noise
    (sigma 1e-4 a part) and one packet on fine channel ``chans[b]`` of
    every band ``b``, all two wideband symbols in, payload ``0x50 + b``,
    upconverted with a float64 carrier phase. Returns planes ``[2, L]``."""
    import dataclasses
    import math

    import torch

    from lora_tpu_torch.parallel import subband_channel_freq
    from lora_tpu_torch.tx.modulator import modulate_frame

    wide_rate = n_dev * M_fine * cfg.samp_rate
    wide_cfg = dataclasses.replace(cfg, samp_rate=wide_rate)
    pos = 2 * wide_cfg.samples_per_symbol
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.view_as_complex(1e-4 * torch.randn((L, 2), generator=gen, device="cuda"))
    for b, c in enumerate(chans):
        pkt = torch.from_numpy(modulate_frame(wide_cfg, bytes([0x50 + b]), snr_db=None))
        pkt = pkt.to("cuda", torch.complex128)
        n = pkt.shape[0]
        check(pos + n <= L, f"subband packet of {n} samples past the capture ({L})")
        f = subband_channel_freq(wide_rate, n_dev, M_fine, b, c)
        t = torch.arange(pos, pos + n, dtype=torch.float64, device="cuda")
        cycles = torch.remainder(t * (f / wide_rate), 1.0)
        x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(cycles), 2.0 * math.pi * cycles)
                           ).to(torch.complex64)
        del pkt, t, cycles
    return torch.stack([x.real, x.imag]).contiguous()


def phase_sharding(cfg, x, expected, pkt_len, rx, xd, smi_line):
    """(a)-(e) of the sharding package (``lora_tpu_torch.parallel``) on the
    one card, each part's counts zeroed just before its gated call and read
    just after, then timed (median of 3 wall ms): (a) channel sharding of
    the dense bench block ``xd`` over 4 shards of the card; (b) time
    sharding of streaming (a)'s capture over 4 shards; (c) wideband time
    sharding at wideband-1024 over 4 shards; (d) subband sharding at
    10,240 channels over 8 shards, its K4 launches split by filterbank; (e)
    the group code path at world size 1 (an NCCL group of one rank, whose
    halo and exchange are local copies; NCCL runs one ``all_reduce``)
    against the one-shard in-process mesh, bit-equal. Also K4 at the coarse
    filterbank's shape and on the same planes at M = 4 and 1, each with its
    launch geometry, and the scalar instantiation's pick at M = 1. Returns
    ``(launches by part, the coarse K4 timings by M)``."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from lora_tpu_torch import DenseReceiver, LoRaConfig, WidebandReceiver
    from lora_tpu_torch.channelizer import PolyphaseChannelizer, firdes_low_pass
    from lora_tpu_torch.ops.cuda_kernels import (_pfb_vector_width, pfb_fir_kernel,
                                                 pfb_fir_planes)
    from lora_tpu_torch.ops.xfer import pack_iq
    from lora_tpu_torch.parallel import (channel_sharded_process, make_mesh,
                                         time_sharded_process, wideband_subband_sharded_process,
                                         wideband_time_sharded_process)

    launches, ms = {}, {}
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    print(f"sharding: {mesh4!r} on {smi_line}")

    # (a) channel sharding of the bench block: 16 channels a shard
    fn_a = channel_sharded_process(rx, mesh4)
    res, launches["a"], ms["a"] = run_sharded(fn_a, xd, "(a) channels", {"det_metrics": 4})
    check(tuple(res.valid.shape) == (x.shape[0], rx.P), "(a) result shape")
    check(gate(res, expected, "sharding (a)") == expected, f"(a): not {expected} frames")
    one = rx.process_planes(xd)
    same_results(res, one, "(a) against one process_planes")
    one_ms = statistics.median(call_ms(lambda: rx.process_planes(xd), 3))
    print(f"sharding (a): {int(res.valid.sum())}/{expected} placements, the lanes of one "
          f"process_planes of the whole block (that call {one_ms:.3f} ms)")
    del res, one

    # (b) time sharding of streaming (a)'s capture, rolled by half a block
    # and half a packet so that the seams fall inside rows of back-to-back
    # packets (a block is 16 rows); the ring stays continuous: the roll's
    # own join lies in the zeros between the last row and the first
    stream, placements = dense_stream(x, pkt_len)
    n4, B = 4, len(stream) // 4
    shift = B // 2 + pkt_len // 2
    stream = np.roll(stream, shift)
    placements = [(sf, c, (i + shift) % len(stream), pl) for sf, c, i, pl in placements]
    xs = pack_iq(stream)
    # the main path's receiver has the same packet region (halo)
    per_shard = [sum(d * B <= p[2] < (d + 1) * B + rx.pkt_samples for p in placements)
                 for d in range(n4)]
    P = 1024
    check(max(per_shard) + 64 <= P, f"(b): {max(per_shard)} packets a shard for {P} lanes")
    rx_t = DenseReceiver(cfg, max_candidates=P, max_symbols=24, sfd_search=12,
                         demod_method="fft")
    # a packet's signal: from its placement for pkt_len less the 2 x 4096
    # samples of padding around it
    seams = sum(any(0 < (d * B - p[2]) % len(stream) < pkt_len - 8192 for p in placements)
                for d in range(n4))
    print(f"sharding (b): {len(stream)} samples, {len(placements)} packets, blocks of {B}, "
          f"halo {rx_t.pkt_samples}; max_candidates {P} for at most {max(per_shard)} packets "
          f"a shard (block and halo); {seams} of {n4} seams (the ring's join included) with a "
          f"packet across")
    fn_b = time_sharded_process(rx_t, mesh4)
    res, launches["b"], ms["b"] = run_sharded(fn_b, xs, "(b) time", {"det_metrics": 4})
    check(tuple(res.valid.shape) == (n4, P), "(b) result shape")
    check(seams >= 1, "(b): no packet across a seam")
    frames = seam_second_claims(sharded_frames(res, B), placements, B, n4, rx.sps,
                                pkt_len - 8192, "sharding (b)")
    stream_gate(frames, placements, "sharding (b) time", lambda sf: rx.sps)
    del res

    # (c) wideband time sharding at wideband-1024
    M = 1024
    active = list(range(0, M, 16))
    wcfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wr = WidebandReceiver(wcfg, M, max_candidates=2, max_symbols=24, sfd_search=12,
                          demod_method="fft")
    halo = (wr.rx.pkt_samples + wr.pfb.K + 1) * M
    unit = M * wr.rx.sps
    blk = -(-2 * halo // unit) * unit
    host, wplace, n_pkt = wideband_stream_capture(wcfg, M, active, 4 * blk, seed=12)
    xw = pack_iq(host)
    del host
    seams = sum(any(p[2] * M < d * blk < p[2] * M + n_pkt for p in wplace) for d in range(1, 4))
    print(f"sharding (c): L = {4 * blk} ({4 * blk // M} channel samples), blocks of {blk}, "
          f"halo {halo} wideband samples ({blk / halo:.2f} halos a block), {len(wplace)} "
          f"packets, {seams} of 3 seams with a packet across")
    fn_c = wideband_time_sharded_process(wr, mesh4)
    res, launches["c"], ms["c"] = run_sharded(fn_c, xw, "(c) wideband time",
                                              {"det_metrics": 4, "pfb_fir": 4})
    check(tuple(res.valid.shape) == (4, M, wr.rx.P), "(c) result shape")
    check(seams >= 1, "(c): no packet across a seam")
    frames = seam_second_claims(sharded_frames(res, blk // M, wcfg.sf), wplace, blk // M, 4,
                                wr.rx.sps, n_pkt // M, "sharding (c)")
    stream_gate(frames, wplace, "sharding (c) wideband time", lambda sf: wr.rx.sps)
    del res, xw

    # (d) subband sharding at 10,240 channels
    n8, M_fine = 8, 1280
    scfg = LoRaConfig(sf=6, cr=1, samp_rate=250e3, implicit=True, crc=False)
    sr = WidebandReceiver(scfg, M_fine, pool=8, max_candidates=1, max_symbols=12,
                          sfd_search=10, demod_method="fft")
    sps = scfg.samples_per_symbol
    step = n8 * n8 * M_fine
    Ls = -(-(n8 * M_fine * (sr.rx.pkt_samples // sps + 16) * sps) // step) * step
    chans = [7 + 41 * b for b in range(n8)]
    xb = subband_10k_capture(n8, M_fine, scfg, Ls, chans)
    mesh8 = make_mesh(devices=["cuda:0"] * n8)
    fn_d = wideband_subband_sharded_process(sr, mesh8)
    print(f"sharding (d): {n8} x {M_fine} = {n8 * M_fine} channels, L = {Ls} "
          f"({xb.numel() * 4 / 1e9:.3f} GB float32), packets on fine channels {chans}")
    by_m = {}
    res, launches["d"], ms["d"] = run_sharded(fn_d, xb, "(d) subband 10k",
                                              {"det_metrics": n8, "pfb_fir": 2 * n8},
                                              during=pfb_launches_by_m(by_m))
    print(f"sharding (d): pfb_fir launches of the gated call by filterbank M {by_m} "
          f"(coarse M = {n8}, fine M = {M_fine})")
    check(by_m == {n8: n8, M_fine: n8},
          f"(d): pfb_fir launches by filterbank {by_m}, not {n8} coarse and {n8} fine")
    check(tuple(res.valid.shape) == (n8, sr.pool), "(d) result shape")
    valid = res.valid.cpu().numpy()
    chan, pay = res.channel.cpu().numpy(), res.payload.cpu().numpy()
    drops = res.n_dropped.cpu().numpy()
    hit = [any(chan[b, g] == chans[b] and pay[b, g, 0] == 0x50 + b
               for g in np.nonzero(valid[b])[0]) for b in range(n8)]
    print(f"sharding (d): {sum(hit)}/{n8} bands decode their packet; valid lanes by band "
          f"{valid.sum(axis=1).tolist()}; n_dropped by band {drops.tolist()}")
    check(all(hit), f"(d): bands {[b for b in range(n8) if not hit[b]]} missed their packet")
    check((drops >= 0).all(), "(d): negative n_dropped")

    # K4 at the coarse filterbank's shape (M = n_dev, K = 13) on a shard's
    # block and halo, and at the same planes with the prototype at M = 4
    # and 1 (the narrow tile); the scalar pick at M = 1 on a cut
    wide_rate = sr.wide_rate * n8
    coarse = PolyphaseChannelizer(n8, firdes_low_pass(1.0, wide_rate, 0.42 * wide_rate / n8,
                                                      wide_rate / n8 / 5.0))
    ext = xb[:, : Ls // n8 + (coarse.K + 1) * n8].contiguous()
    coarse_fir = {}
    for n in (n8, 4, 1):
        rate = sr.wide_rate * n
        cn = coarse if n == n8 else PolyphaseChannelizer(
            n, firdes_low_pass(1.0, rate, 0.42 * rate / n, rate / n / 5.0))
        got = pfb_fir_kernel(ext, cn._h)
        check(torch.equal(got, pfb_fir_planes(ext, cn._h)),
              f"K4 at the coarse shape, M = {n}, differs from its plain version")
        st = pfb_times(ext, cn._h, torch.float32)
        st["launches"] = by_m.get(n, 0)
        st["geometry"] = pfb_tile(ext, cn._h, torch.float32)
        coarse_fir[n] = st
        print_pfb_times(f"coarse M={n}", st,
                        f"launches in the gated (d) call {st['launches']}")
        del got
    print(f"pfb_fir coarse: launches in the gated (d) call {by_m[n8]} at M = {n8} (and "
          f"{by_m[M_fine]} fine at M = {M_fine})")
    one_taps = firdes_low_pass(1.0, 1.0, 0.42, 0.2)
    c1 = PolyphaseChannelizer(1, one_taps)
    x1 = xb[:, :4096].contiguous()
    out1 = torch.empty((4096 - c1.K + 1, 2, 1), device="cuda")
    width = _pfb_vector_width(x1, c1._h, out1)
    got1 = pfb_fir_kernel(x1, c1._h, out=out1)
    check(width == 1 and torch.equal(got1, pfb_fir_planes(x1, c1._h)),
          f"K4 at M = 1: vector width {width}, or not its plain version")
    print(f"pfb_fir at M = 1 (world size 1's coarse filterbank, K = {c1.K}): the scalar "
          f"instantiation (width {width}), bit-equal to its plain version")
    del res, xb, ext, got1

    # (e) the group code path at world size 1: an NCCL group of one rank
    # runs (a)'s and (b)'s functions on a cut of their inputs, bit-equal to
    # the in-process one-shard mesh. At one rank the halo and the band
    # exchange are local copies: NCCL is initialised and runs one
    # all_reduce, but no transfer of the port's goes over it
    one_mesh = make_mesh(devices=["cuda:0"])
    cut_a, cut_b = xd[:8], xs[:, : len(stream) // 8]
    want = {"a": channel_sharded_process(rx, one_mesh)(cut_a),
            "b": time_sharded_process(rx_t, one_mesh)(cut_b)}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group_mesh = make_mesh(group=dist.group.WORLD)
        print(f"sharding (e): {group_mesh!r}, backend {dist.get_backend()}")
        fn_e = {"a": channel_sharded_process(rx, group_mesh),
                "b": time_sharded_process(rx_t, group_mesh)}
        for k, cut in (("a", cut_a), ("b", cut_b)):
            res, launches[f"e{k}"], ms[f"e{k}"] = run_sharded(
                fn_e[k], cut, f"(e) NCCL world size 1, ({k})'s function", {"det_metrics": 1})
            same_results(res, want[k], f"(e) ({k})", exact=True)
            # NCCL's one collective here: the frames summed over the group
            total = res.valid.sum(dtype=torch.int64)
            dist.all_reduce(total, group=group_mesh.group)
            check(int(total) == int(res.valid.sum()), f"(e) ({k}): all_reduce {int(total)}")
            print(f"sharding (e) ({k}): {int(total)} frames (summed over the group by "
                  f"all_reduce), every field bit-equal to the one-shard mesh")
    finally:
        dist.destroy_process_group()
    del xs, want
    torch.cuda.empty_cache()
    print("sharding: median wall ms by part " + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    return launches, coarse_fir


def main() -> int:
    import torch

    import lora_tpu_torch  # noqa: F401  (without the package: fail before any output)

    device_name, smi_line = phase_device()
    phase_build()
    stamp("phase_build")
    phase_bench()
    stamp("phase_bench")
    worst = phase_kernel_vs_plain()
    worst_fir = phase_pfb_vs_plain()
    worst_lag = phase_lag_vs_plain()
    worst_fused = phase_fused_vs_plain()
    worst_variants = phase_variants_vs_plain()
    stamp("phase_variants_vs_plain")
    cfg, x, expected, pkt_len = bench_block()
    rx, planes, launches = phase_main_path(cfg, x, expected)
    phase_run_small(cfg, x, pkt_len)
    stamp("phase_run_small")
    tools = phase_tools()
    stamp("phase_tools")
    phase_timing_study()
    stamp("phase_timing_study")
    grad_rx = phase_gradient(cfg, expected, rx, planes[torch.float32])
    phase_run_small(cfg, x, pkt_len, method="gradient")
    stamp("phase_run_small")
    receivers, xd_wide, wide_launches = phase_wideband()
    phase_wideband_run_small()
    stamp("phase_wideband_run_small")
    gw, xd_gw, gw_launches = phase_gateway()
    phase_gateway_run_small()
    stamp("phase_gateway_run_small")
    plans = phase_plan_gateway()
    phase_plan_run_small()
    stamp("phase_plan_run_small")
    for when in ("before profile", "after profile"):
        phase_throughput("dense_rx_throughput", dense_calls(rx, planes), when,
                         device_name, smi_line)
        phase_throughput("wideband_1024ch_throughput", wideband_calls(receivers, xd_wide),
                         when, device_name, smi_line)
        phase_throughput("gateway_256ch_6sf_throughput", gateway_calls(gw, xd_gw), when,
                         device_name, smi_line)
        for plan, (pgw, pxd, _) in plans.items():
            phase_throughput(f"plan_gateway_{plan.lower()}_6sf_throughput",
                             plan_calls(pgw, pxd), when, device_name, smi_line)
        if when == "before profile":
            # the profiler first runs after every path has run: kernels of
            # libraries loaded after its first use went untraced
            phase_profile("dense", dense_calls(rx, planes))
            phase_profile("dense gradient",
                          {"float32": (grad_rx.process, planes[torch.float32], None)})
            phase_profile_wideband(receivers, xd_wide)
            phase_profile_gateway(gw, xd_gw)
            phase_profile("plan EU868", plan_calls(*plans["EU868"][:2]))
            phase_profile_plan(*plans["US915"][:2])
        stamp(f"throughput ({when})")
    # after the profiler's phases, whose traces must keep every kernel of
    # the paths (a profile of a streamed run before them left K3, K4 and K5
    # out of their traces)
    phase_stream_dense(cfg, x, pkt_len, smi_line)
    stamp("phase_stream_dense")
    phase_stream_wideband(smi_line)
    stamp("phase_stream_wideband")
    _, plan_stream = phase_stream_plan(smi_line)
    stamp("phase_stream_plan")
    variants = phase_variant_times(planes[torch.float32], rx.sps)
    stamp("phase_variant_times")
    facade_launches = phase_facade(smi_line)
    stamp("phase_facade")
    phase_suites(smi_line)
    stamp("phase_suites")
    phase_low_snr(smi_line)
    stamp("phase_low_snr")
    phase_implicit_debug()
    stamp("phase_implicit_debug")
    phase_parity(smi_line)
    stamp("phase_parity")
    graph_launches = phase_flowgraph(smi_line, plan_stream)
    del plan_stream
    stamp("phase_flowgraph")
    shard_launches, coarse_fir = phase_sharding(cfg, x, expected, pkt_len, rx,
                                                planes[torch.float32], smi_line)
    stamp("phase_sharding")
    phase_kernel_times(rx, planes, launches, worst, receivers, xd_wide, wide_launches,
                       worst_fir, gw, xd_gw, gw_launches, worst_lag, plans, worst_fused,
                       variants, tools, worst_variants, facade_launches, graph_launches,
                       shard_launches, coarse_fir)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
