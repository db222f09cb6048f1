"""Per-stage timing study: the counterpart of the reference's
``DBGR_CHRONO`` tracing.

The reference times its state machine's sections with ``std::chrono``
(``lib/dbugr.hpp:99-165``, used from ``lib/decoder_impl.cc:494-504``) and
aggregates the samples into ``examples/lora-timings/timing-results.txt``.
This module times each receiver stage (DETECT, SYNC, SFD, demod, integer
decode) as the batched torch call the port's receiver runs, normalised to
the reference's units (per window, event, symbol or frame), so the two
tables read side by side.

- On the card the detect stage runs the detection kernel
  (:func:`~lora_tpu_torch.ops.cuda_kernels.detection_metrics_kernel`) and
  :func:`pfb_timings` the polyphase FIR kernel; on the CPU their plain
  versions.
- A stage is timed after one warm-up call, as the best of ``rounds``
  rounds of ``iters`` back-to-back calls that end in a
  ``torch.cuda.synchronize()`` barrier, divided by the batch: the
  per-unit cost at the throughput operating point (a single-window call
  would time the launch, not the work).
- Every result names its device; ``device=None`` is the card, and a
  missing card raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import LoRaConfig
from .device import full_f32_matmul, resolve_device
from .ops import demod
from .ops.chirp import build_ideal_chirps, instantaneous_frequency_np, tiled_upchirp_ifreq
from .ops.xfer import pack_iq
from .rx.dense import FOLD_BUDGET, DenseReceiver

# the reference's published CPU numbers, ms
# (examples/lora-timings/timing-results.txt)
REF_MS = {
    (7, "gradient", "demod"): 0.1189,
    (7, "fft", "demod"): 0.0706,
    (12, "gradient", "demod"): 3.7576,
    (12, "fft", "demod"): 2.2099,
    (7, "gradient", "detect"): 0.0112,
    (12, "gradient", "detect"): 16.70,
    (7, "gradient", "sync"): 0.137,
}
UNITS = {"detect": "window", "sync": "event", "sync_parity": "event", "sfd": "window",
         "demod": "symbol", "decode": "frame"}


def _barrier(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn: Callable, args, batch: int, device: torch.device, iters: int = 5,
             rounds: int = 3) -> float:
    """Best-of-rounds seconds a unit of ``fn(*args)``, ``batch`` units a
    call."""
    fn(*args)
    _barrier(device)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _barrier(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best / batch


def _complex(wf: torch.Tensor) -> torch.Tensor:
    """Packed planes ``[..., 2, n]`` -> complex ``[..., n]``."""
    return torch.complex(wf[..., 0, :], wf[..., 1, :])


def stage_timings(
    sf: int = 7,
    method: str = "gradient",
    samp_rate: float = 1e6,
    batch_windows: int = 2048,
    batch_symbols: int = 512,
    batch_frames: int = 64,
    iters: int = 5,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Per-stage times of one (sf, demod method) config on ``device``.

    Returns ``{stage: seconds_per_unit}`` with the reference's stage names:
    ``detect`` (per 2-symbol window), ``sync`` (per event; the gradient
    engine's fast sync, and ``sync_parity`` the reference's sliding
    search), ``sfd`` (per window), ``demod`` (per symbol, gradient or fft),
    ``decode`` (per frame, the integer chain), plus ``samples_per_symbol``.
    """
    from .ops.cuda_kernels import detection_metrics_kernel

    dev = resolve_device(device)
    cfg = LoRaConfig(sf=sf, cr=4, samp_rate=samp_rate, crc=True, reduced_rate=sf > 10)
    sps, nb, decim = cfg.samples_per_symbol, cfg.number_of_bins, cfg.decim_factor
    rng = np.random.default_rng(seed)

    def noise(*shape):
        return (rng.normal(0, 1.0, shape + (2,)).astype(np.float32)
                @ np.array([1, 1j], np.complex64)).astype(np.complex64)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    up, down = build_ideal_chirps(cfg)
    down_t, up_ifreq = on_dev(down), on_dev(instantaneous_frequency_np(up))
    down_ifreq = on_dev(instantaneous_frequency_np(down))
    up_ifreq_v = on_dev(tiled_upchirp_ifreq(cfg))
    # the fold-DFT matmul only within the receiver's own table budget: at
    # SF12 at 1 Msps the matrix would hold 134M entries
    fold = (tuple(on_dev(m) for m in demod.make_fold_dft(down, sps, nb))
            if method == "fft" and sps * nb <= FOLD_BUDGET else None)

    t: Dict[str, float] = {"samples_per_symbol": float(sps)}
    with full_f32_matmul():
        # DETECT: the dense metric, per 2-symbol window
        stream = pack_iq(noise((batch_windows + 1) * sps), device=dev)
        t["detect"] = _time_fn(lambda x: detection_metrics_kernel(x, sps)[0], (stream,),
                               batch_windows, dev, iters)
        del stream

        # SYNC: upchirp alignment over a 2-symbol window, per event
        nsync = max(16, batch_symbols // 8)
        wins2 = pack_iq(noise(nsync, 2 * sps), device=dev)
        if method == "fft":
            def sync(wf):
                return demod.upchirp_sync_coarse_fine(_complex(wf), down_t, up_ifreq, sps, nb,
                                                      decim, fold_mat=fold)
        else:
            def sync(wf):
                return demod.upchirp_sync_grad(_complex(wf), up_ifreq, sps, nb, decim)

            t["sync_parity"] = _time_fn(
                lambda wf: demod.upchirp_sync_xcorr(_complex(wf), up_ifreq, sps)[0],
                (wins2,), nsync, dev, iters)
        t["sync"] = _time_fn(sync, (wins2,), nsync, dev, iters)
        del wins2

        # SFD: the downchirp Pearson, per window
        wins1 = pack_iq(noise(batch_symbols, sps), device=dev)
        t["sfd"] = _time_fn(lambda wf: demod.downchirp_pearson(_complex(wf), down_ifreq, sps),
                            (wins1,), batch_symbols, dev, iters)

        # demod: per symbol
        if method == "fft":
            if fold is not None:
                def dm(wf):
                    return demod.fft_shift_idx_mm(_complex(wf), fold)
            else:  # the dechirp FFT, the receiver's own no-fold path
                def dm(wf):
                    return demod.fft_shift_idx(_complex(wf), down_t, nb, sps)
        else:
            def dm(wf):
                w = _complex(wf)
                b = demod.max_frequency_gradient_idx(w, nb, decim)
                return b, demod.fine_sync_lag(w, b, up_ifreq_v, sps, decim,
                                              demod.fine_sync_search_space(decim))
        t["demod"] = _time_fn(dm, (wins1,), batch_symbols, dev, iters)
        del wins1

        # decode: the integer chain per frame (gray .. payload bytes)
        drx = DenseReceiver(cfg, max_candidates=1, max_symbols=24, sfd_search=12,
                            demod_method="fft", device=dev)
        words = on_dev(rng.integers(0, nb, (batch_frames, 8 + 24)).astype(np.int32))
        ok = torch.ones(batch_frames, dtype=torch.bool, device=dev)
        t["decode"] = _time_fn(lambda w: drx._finish_decode(w, ok)[0], (words,),
                               batch_frames, dev, iters)
    return t


def timing_table(sfs=(7, 12), methods=("gradient", "fft"), samp_rate: float = 1e6,
                 iters: int = 5, device=None, timings: Optional[dict] = None) -> str:
    """The shape of ``examples/lora-timings/timing-results.txt``: per-stage
    times for each (SF, demod method) in ms (four significant digits),
    beside the reference's published CPU numbers where it has them. The
    header names the device. ``timings``: an optional dict that receives
    each :func:`stage_timings` result under ``(sf, method)``."""
    dev = resolve_device(device)
    label = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    lines: List[str] = [
        f"# Per-stage receiver timings ({label})",
        "",
        "Per-unit stage timings of the batched torch calls, comparable to",
        "the reference's DBGR_CHRONO study",
        "(`examples/lora-timings/timing-results.txt`; methodology in",
        "`lora_tpu_torch/profiling.py`). `ref CPU` columns are the reference's",
        "published numbers.",
        "",
        "| SF | method | stage | unit | this (ms) | ref CPU (ms) | speedup |",
        "|---|---|---|---|---|---|---|",
    ]
    for sf in sfs:
        for method in methods:
            t = stage_timings(sf=sf, method=method, samp_rate=samp_rate, iters=iters,
                              device=device)
            if timings is not None:
                timings[(sf, method)] = t
            for stage in UNITS:
                if stage not in t:
                    continue
                ms = t[stage] * 1e3
                # the sliding search is what the reference's sync row times
                ref = REF_MS.get((sf, method, "sync" if stage == "sync_parity" else stage))
                ref_s = f"{ref:.4f}" if ref is not None else "—"
                spd = f"{ref / ms:,.0f}x" if ref else "—"
                lines.append(f"| {sf} | {method} | {stage} | {UNITS[stage]} "
                             f"| {ms:.4g} | {ref_s} | {spd} |")
    return "\n".join(lines) + "\n"


def pfb_timings(n_channels: int = 1024, chan_rate: float = 250e3, block_symbols: int = 96,
                iters: int = 5, seed: int = 0, device=None) -> Dict[str, float]:
    """The channelizer stage: the packed-plane PFB
    (:meth:`~lora_tpu_torch.channelizer.PolyphaseChannelizer.planes`, the
    polyphase FIR kernel and the DFT product) in seconds per wideband
    Msample, float32 and bf16 channel planes."""
    from .channelizer import PolyphaseChannelizer

    dev = resolve_device(device)
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=chan_rate, crc=True)
    M = int(n_channels)
    L = M * block_symbols * cfg.samples_per_symbol
    pfb = PolyphaseChannelizer.for_lora(M * chan_rate, M, cfg.bandwidth, device=dev)
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1.0, (L, 2)).astype(np.float32)
         @ np.array([1, 1j], np.complex64)).astype(np.complex64)
    xd = pack_iq(x, device=dev)
    out: Dict[str, float] = {}
    with full_f32_matmul():
        for name, dt in (("pfb_f32", torch.float32), ("pfb_bf16", torch.bfloat16)):
            per_call = _time_fn(lambda xf, dt=dt: pfb.planes(xf, out_dtype=dt), (xd,), 1, dev,
                                iters)
            out[name] = per_call / (L / 1e6)
    return out


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="per-stage timing study")
    p.add_argument("--sfs", type=int, nargs="+", default=[7, 12])
    p.add_argument("--methods", nargs="+", default=["gradient", "fft"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--pfb", type=int, default=0, metavar="M",
                   help="also time the M-channel PFB planes stage")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="write markdown here")
    args = p.parse_args(argv)
    table = timing_table(tuple(args.sfs), tuple(args.methods), iters=args.iters,
                         device=args.device)
    if args.pfb:
        t = pfb_timings(args.pfb, iters=args.iters, device=args.device)
        table += (f"\nPFB ({args.pfb} ch): f32 {t['pfb_f32'] * 1e3:.4f} ms/Msample, "
                  f"bf16 {t['pfb_bf16'] * 1e3:.4f} ms/Msample\n")
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
