"""Throughput bench of the port: the stages of the repo-root ``bench.py``.

    python -m lora_tpu_torch.bench                        # every stage, dense last
    python -m lora_tpu_torch.bench --wideband [M]         # M = 1024
    python -m lora_tpu_torch.bench --wideband-full [M]    # every channel active, M = 1024
    python -m lora_tpu_torch.bench --gateway [M]          # M channels x SF7-12, M = 256
    python -m lora_tpu_torch.bench --plan-gateway [PLAN]  # EU868 (2 Msps) or US915 (8 Msps)
    python -m lora_tpu_torch.bench --dense-only [CHANNELS] [--no-bf16]   # 64 channels
    ... [--device cpu]

Each stage builds ``bench.py``'s capture for it: the same length, active
channels, placements, SFs, payload and sync word. The noise is drawn on
the host from ``np.random.default_rng(0)``, bit-equal to ``bench.py``'s;
the packets come from the port's modulator and are upconverted on the
capture's device with ``bench.py``'s float64 phase (the full-occupancy
stage by its complex64 phasor recurrence), and ``ops.xfer.pack_iq``
splits the capture into planes there. The receiver takes ``bench.py``'s
constructor arguments.

The stage's first call is gated: every placement decoded where it was
put, no valid lane with another payload, and no candidate dropped at
full occupancy. A miss raises :class:`GateFailure`, and the command says
so on stderr, prints no metric line and exits 1. The timed calls follow:
the best of 5 rounds of 10 calls (5 for the gateway, plan and
full-occupancy stages) with a ``torch.cuda.synchronize()`` before a
round's first call and after its last, stopping early once 150 s (dense)
or 120 s (the others) are spent. A metric's value is the samples of a
call over the best round's time a call, in Msamples/s, printed as one
JSON line with ``bench.py``'s keys. The card's name and ``nvidia-smi``'s
name and power limit go to stderr before the first line.

With no stage flag, every stage runs in ``bench.py``'s order, each in its
own process under ``bench.py``'s time limit, after the kernels are built
once; the run then exits 1 and names each stage that failed or ran out
of time. A positional channel count and ``--no-bf16`` go to the dense
stage. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .channelizer import pfb_channel_freqs
from .config import LoRaConfig
from .device import resolve_device
from .ops.xfer import pack_iq
from .plans import PlanGateway
from .rx.dense import DenseReceiver
from .tx.modulator import modulate_frame
from .wideband import MultiSFWidebandReceiver, WidebandReceiver

DEADBEEF = b"\xde\xad\xbe\xef"
GATEWAY_SFS = (7, 8, 9, 10, 11, 12)
# bench.py --plan-gateway's (center Hz, sample rate); any other plan takes EU868's
PLAN_GEOMS = {"US915": (903.0e6, 8e6), "AU915": (919.0e6, 8e6)}
EU868_GEOM = (868.0e6, 2e6)
# bench.py's stage list and time limits (s); the dense stage runs after them
STAGES = ((["--wideband", "256"], 420.0), (["--wideband", "1024"], 540.0),
          (["--wideband", "4096"], 540.0), (["--gateway", "256"], 540.0),
          (["--wideband-full", "1024"], 540.0), (["--plan-gateway", "EU868"], 540.0),
          (["--plan-gateway", "US915"], 540.0))
DENSE_TIMEOUT_S = 540.0
_KW = dict(max_candidates=2, max_symbols=24, sfd_search=12, demod_method="fft")


class GateFailure(RuntimeError):
    """A stage's first call missed its decode gate."""


class StageResult(NamedTuple):
    lines: list    # the metric records printed, in order
    lanes: tuple   # each gated call's valid lanes, on the host
    rates: list    # each line's Msamples/s before rounding, in the order of ``lines``


def _check(cond, msg: str) -> None:
    if not cond:
        raise GateFailure(msg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- captures

def noise(L: int) -> np.ndarray:
    """``bench.py``'s noise, complex64 ``[L]``: the rows of
    ``np.random.default_rng(0).normal(0, 1e-3, (L, 2))`` in float32 as
    (real, imag), bit-equal to its ``@ [1, 1j]`` product."""
    f = np.random.default_rng(0).normal(0, 1e-3, (L, 2)).astype(np.float32)
    return f.view(np.complex64).reshape(L)


def _omega(f, rate) -> float:
    """``bench.py``'s carrier in radians a sample: the imaginary part of
    its scalar ``2j * np.pi * f / rate``, by the same numpy (or Python)
    arithmetic, so the float64 phase ``omega * t`` is its to the bit."""
    return float((2j * np.pi * f / rate).imag)


def _add_packet(x: torch.Tensor, pkt: torch.Tensor, pos: int, omega: float) -> None:
    """``x[pos:pos+n] += (pkt * exp(1j * omega * t)).to(complex64)`` for
    ``t = pos .. pos+n-1``: ``bench.py``'s upconversion, in float64 on
    ``x``'s device (``pkt`` complex128 there)."""
    n = pkt.shape[0]
    t = torch.arange(pos, pos + n, dtype=torch.float64, device=x.device)
    x[pos:pos + n] += (pkt * torch.polar(torch.ones_like(t), omega * t)).to(torch.complex64)


def dense_capture(n_channels: int = 64, block_symbols: int = 2048):
    """``bench.py``'s dense block (``bench.py:356-380``) on the host: SF7
    CR4/8 at 1 Msps, ``n_channels`` x ``block_symbols`` symbols, each
    channel back-to-back 40 dB ``deadbeef`` packets (4096 samples of pad
    each side) behind ``997 * c`` samples of zeros. Returns ``(config,
    x complex64 [C, L], expected frames)``: ``min(8, packets a
    channel)`` each."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    block_len = block_symbols * cfg.samples_per_symbol
    pkt = modulate_frame(cfg, DEADBEEF, pad_before=4096, pad_after=4096, snr_db=40.0)
    reps = block_len // len(pkt)
    tiled = np.tile(pkt, max(1, reps))
    x = np.zeros((n_channels, block_len), np.complex64)
    for c in range(n_channels):
        n = max(0, min(block_len - 997 * c, len(tiled)))
        x[c, 997 * c:997 * c + n] = tiled[:n]
    return cfg, x, n_channels * min(8, reps)


def _wideband_geometry(M: int):
    """SF7 CR4/8 channels at 250 ksps, the wideband rate, ``L = M * 96 *
    256`` and the ``deadbeef`` packet at the wideband rate."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    wide_cfg = LoRaConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    pkt = modulate_frame(wide_cfg, DEADBEEF, snr_db=None)
    return cfg, wide_rate, M * 96 * cfg.samples_per_symbol, pkt


def _wideband_pos(c: int, M: int, cfg, L: int, n: int) -> int:
    return min((8 + (c % 7)) * cfg.samples_per_symbol * M // 8, L - n - 1)


def wideband_capture(n_channels: int = 1024, device=None):
    """``bench.py --wideband``'s capture (``bench.py:40-58``): ``L = M *
    96 * 256`` samples of noise and the ``deadbeef`` packet on every
    ``M // 64``-th channel, at ``(8 + c % 7) / 8`` symbols of the channel
    rate. Returns ``(channel config, x complex64 [L] on device, active
    channels)``."""
    dev = resolve_device(device)
    M = n_channels
    cfg, wide_rate, L, pkt = _wideband_geometry(M)
    x = torch.from_numpy(noise(L)).to(dev)
    freqs = pfb_channel_freqs(wide_rate, M)
    active = list(range(0, M, max(1, M // 64)))
    p = torch.from_numpy(pkt).to(dev, torch.complex128)
    for c in active:
        _add_packet(x, p, _wideband_pos(c, M, cfg, L, len(pkt)), _omega(freqs[c], wide_rate))
    return cfg, x, active


def full_occupancy_capture(n_channels: int = 1024, device=None):
    """``bench.py --wideband-full``'s capture (``bench.py:282-310``):
    ``wideband_capture``'s length and placements with the packet on every
    channel, upconverted by its complex64 phasor recurrence (one running
    product ``vec *= step`` across the channels, ``rot`` a channel's phase
    at its position). Returns ``(channel config, x complex64 [L] on
    device, every channel)``."""
    dev = resolve_device(device)
    M = n_channels
    cfg, wide_rate, L, pkt = _wideband_geometry(M)
    x = torch.from_numpy(noise(L)).to(dev)
    freqs = pfb_channel_freqs(wide_rate, M)
    n = len(pkt)
    tpk = torch.arange(n, dtype=torch.float64, device=dev)
    one = torch.ones_like(tpk)
    step = torch.polar(one, _omega(freqs[1] - freqs[0], wide_rate) * tpk).to(torch.complex64)
    vec = torch.polar(one, _omega(freqs[0], wide_rate) * tpk).to(torch.complex64)
    del tpk, one
    p = torch.from_numpy(pkt).to(dev)
    for c in range(M):
        pos = _wideband_pos(c, M, cfg, L, n)
        rot = complex(np.complex64(np.exp(2j * np.pi * freqs[c] / wide_rate * pos)))
        x[pos:pos + n] += p * (rot * vec)
        if c + 1 < M:
            vec *= step
    return cfg, x, list(range(M))


def gateway_capture(gw, device=None):
    """``bench.py --gateway``'s capture (``bench.py:113-140``) for the
    gateway ``gw`` (its ``M`` and SFs): ``L = M * (max_pkt_samples + 6 *
    max_sps)`` samples of noise and one ``deadbeef`` packet on every
    ``M // 24``-th channel, SFs round-robin, each two symbols of its own
    SF in (a packet that does not fit is left out, as there). Returns ``(x
    complex64 [L] on device, {(sf, channel)})``."""
    dev = resolve_device(device)
    M, wide_rate = gw.M, gw.wide_rate
    max_sps = max(rx.sps for rx in gw.rxs.values())
    L = M * (gw.max_pkt_samples + 6 * max_sps)
    x = torch.from_numpy(noise(L)).to(dev)
    freqs = pfb_channel_freqs(wide_rate, M)
    pkts, expect = {}, set()
    for i, c in enumerate(range(0, M, max(1, M // 24))):
        sf = gw.sfs[i % len(gw.sfs)]
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=wide_rate, crc=True)
        if sf not in pkts:  # the same packet on each of its channels: modulated once
            pkts[sf] = torch.from_numpy(modulate_frame(wcfg, DEADBEEF, snr_db=None)).to(
                dev, torch.complex128)
        pos = 2 * wcfg.samples_per_symbol
        if pos + pkts[sf].shape[0] > L:
            continue
        _add_packet(x, pkts[sf], pos, _omega(freqs[c], wide_rate))
        expect.add((sf, c))
    return x, expect


def plan_capture(gw, device=None):
    """``bench.py --plan-gateway``'s capture (``bench.py:207-228``) for the
    plan gateway ``gw``: ``L = decim * (max_pkt_samples + 6 * max_sps)``
    samples of noise and one ``deadbeef`` packet (sync word 0x34) on every
    in-band channel, SFs round-robin, each two symbols of its own SF in.
    Returns ``(x complex64 [L] on device, {(sf, channel index)})``."""
    dev = resolve_device(device)
    rate = gw.samp_rate
    max_sps = max(rx.sps for rx in gw.rxs.values())
    L = gw.decim * (gw.max_pkt_samples + 6 * max_sps)
    x = torch.from_numpy(noise(L)).to(dev)
    pkts, expect = {}, set()
    for i, f_abs in enumerate(gw.channels):
        sf = gw.sfs[i % len(gw.sfs)]
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        if sf not in pkts:
            pkts[sf] = torch.from_numpy(modulate_frame(wcfg, DEADBEEF, snr_db=None)).to(
                dev, torch.complex128)
        pos = 2 * wcfg.samples_per_symbol
        if pos + pkts[sf].shape[0] > L:
            continue
        _add_packet(x, pkts[sf], pos, _omega(f_abs - gw.center_freq, rate))
        expect.add((sf, i))
    return x, expect


# ------------------------------------------------------------------- gates

def _finite(res, label: str) -> None:
    for name in ("snr", "cfo"):
        _check(bool(getattr(res, name)[res.valid].isfinite().all()),
               f"{label}: non-finite {name}")


def _pooled_lanes(res):
    """A pooled result's valid lanes on the host: ``[(channel, start,
    payload)]``, sorted."""
    valid = res.valid.cpu().numpy()
    chan, start, plen = (getattr(res, f).cpu().numpy()[valid]
                         for f in ("channel", "start", "length"))
    pay = res.payload.cpu().numpy()[valid]
    return sorted((int(c), int(s), bytes(p[:n])) for c, s, p, n in zip(chan, start, pay, plen))


def dense_gate(res, expected: int, label: str) -> tuple:
    """All ``expected`` frames decode ``de ad be ef`` and no valid lane
    has another payload. Returns the valid lanes ``(channel, start,
    payload)``."""
    _finite(res, label)
    valid = res.valid.cpu().numpy()
    start, length = res.start.cpu().numpy(), res.length.cpu().numpy()
    pay = res.payload.cpu().numpy()
    lanes = tuple(sorted((int(c), int(start[c, k]), bytes(pay[c, k][:length[c, k]]))
                         for c, k in zip(*np.nonzero(valid))))
    bad = sum(p[:4] != DEADBEEF for _, _, p in lanes)
    _check(len(lanes) == expected and bad == 0,
           f"{label}: decoded {len(lanes)}/{expected} frames, {bad} wrong payloads")
    return lanes


def wideband_gate(res, active, label: str, no_drops: bool = False) -> tuple:
    """Every active channel decodes ``de ad be ef``, no other channel does,
    no valid lane has another payload and (``no_drops``) no candidate was
    dropped. Returns ``(lanes, channels decoded, n_dropped)``."""
    _finite(res, label)
    lanes = tuple(_pooled_lanes(res))
    good = {c for c, _, p in lanes if p[:4] == DEADBEEF}
    bad = sum(p[:4] != DEADBEEF for _, _, p in lanes)
    n_dropped = int(res.n_dropped)
    _check(good == set(active), f"{label}: channels {sorted(set(active) - good)[:8]} missing, "
           f"{sorted(good - set(active))[:8]} unexpected")
    _check(bad == 0, f"{label}: {bad} valid lanes with another payload")
    _check(not no_drops or n_dropped == 0, f"{label}: n_dropped {n_dropped}")
    return lanes, len(good), n_dropped


def _sf_lanes(results, label: str) -> list:
    """``{sf: pooled result}``'s valid lanes: ``[(sf, channel, start,
    payload)]``."""
    lanes = []
    for sf, res in results.items():
        _finite(res, f"{label} SF{sf}")
        lanes += [(sf, *lane) for lane in _pooled_lanes(res)]
    return lanes


def gateway_gate(results, expect, label: str) -> tuple:
    """Every placement ``(sf, channel)`` decodes ``de ad be ef`` at its own
    SF and no valid lane of any SF has another payload or decodes where no
    packet of its SF was sent. Returns ``(lanes (sf, channel, start,
    payload), placements decoded)``."""
    lanes = _sf_lanes(results, label)
    got = {(sf, c) for sf, c, _, p in lanes if p[:4] == DEADBEEF and (sf, c) in expect}
    bad = sum(p[:4] != DEADBEEF or (sf, c) not in expect for sf, c, _, p in lanes)
    _check(got == expect, f"{label}: placements {sorted(expect - got)[:8]} missing")
    _check(bad == 0, f"{label}: {bad} wrong or misplaced lanes")
    return tuple(sorted(lanes)), len(got)


def plan_gate(results, expect, label: str) -> tuple:
    """Every placement ``(sf, channel)`` decodes ``de ad be ef`` at its own
    SF and channel, and no valid lane has another payload; a ``de ad be
    ef`` lane elsewhere is named on stderr. Returns ``(lanes (sf,
    channel, start, payload), placements decoded)``."""
    lanes = _sf_lanes(results, label)
    got = {(sf, c) for sf, c, _, p in lanes if p[:4] == DEADBEEF and (sf, c) in expect}
    bad = sum(p[:4] != DEADBEEF for *_, p in lanes)
    other = [(sf, c, s) for sf, c, s, p in lanes if p[:4] == DEADBEEF and (sf, c) not in expect]
    _check(got == expect, f"{label}: placements {sorted(expect - got)[:8]} missing")
    _check(bad == 0, f"{label}: {bad} valid lanes with another payload")
    if other:
        print(f"{label}: de ad be ef lanes off the placements (sf, channel, start): {other}",
              file=sys.stderr)
    return tuple(sorted(lanes)), len(got)


# ------------------------------------------------------------------ timing

def best_rate(fn, xd, samples: int, device, rounds: int, iters: int, budget_s: float) -> float:
    """Msamples/s of ``samples`` a call of ``fn(xd)``: the best of
    ``rounds`` rounds of ``iters`` back-to-back calls, with a synchronise
    before each round's first call and after its last, stopping once
    ``budget_s`` seconds are spent."""
    dt = float("inf")
    t_start = time.perf_counter()
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(xd)
        _sync(device)
        dt = min(dt, (time.perf_counter() - t0) / iters)
        if time.perf_counter() - t_start > budget_s:
            break
    return samples / dt / 1e6


def _emit(metric: str, msps: float, **extra) -> dict:
    rec = {"metric": metric, "value": round(msps, 1), "unit": "Msamples/s/chip",
           "vs_baseline": round(msps / 1.0, 1), **extra}
    print(json.dumps(rec), flush=True)
    return rec


# ------------------------------------------------------------------ stages

def main(n_channels: int = 64, bf16: bool = True, block_symbols: int = 2048,
         rounds: int = 5, iters: int = 10, device=None) -> StageResult:
    """``bench.py``'s dense stage (``bench.py:350-467``): the dense
    receiver (``max_candidates=8``, fft engine) on :func:`dense_capture`,
    float32 planes gated, then bfloat16 planes gated and timed (unless
    ``bf16`` is false), then float32 timed: ``dense_rx_throughput_bf16``,
    ``dense_rx_throughput``."""
    dev = resolve_device(device)
    cfg, x, expected = dense_capture(n_channels, block_symbols)
    rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24, sfd_search=12,
                       demod_method="fft", device=dev)
    xd = pack_iq(x, device=dev)
    lanes = [dense_gate(rx.process(xd), expected, "dense float32")]
    samples = x.size
    lines, rates = [], []
    if bf16:
        xb = pack_iq(x, dtype=torch.bfloat16, device=dev)
        lanes.append(dense_gate(rx.process(xb), expected, "dense bfloat16"))
        rates.append(best_rate(rx.process, xb, samples, dev, rounds, iters, 150.0))
        lines.append(_emit("dense_rx_throughput_bf16", rates[-1],
                           decode_ratio=round(len(lanes[-1]) / expected, 3)))
        del xb
    del x
    rates.append(best_rate(rx.process, xd, samples, dev, rounds, iters, 150.0))
    lines.append(_emit("dense_rx_throughput", rates[-1]))
    return StageResult(lines, tuple(lanes), rates)


def main_wideband(n_channels: int = 1024, rounds: int = 5, iters: int = 10,
                  device=None) -> StageResult:
    """``bench.py --wideband`` (``bench.py:22-91``): the PFB receiver with
    ``pool = 2 * active`` and bfloat16 channel planes on
    :func:`wideband_capture`: ``wideband_{M}ch_throughput``."""
    dev = resolve_device(device)
    M = n_channels
    cfg, x, active = wideband_capture(M, dev)
    xd = pack_iq(x, device=dev)
    del x
    wr = WidebandReceiver(cfg, M, pool=2 * len(active), plane_dtype=torch.bfloat16,
                          device=dev, **_KW)
    lanes, good, _ = wideband_gate(wr.process(xd), active, f"wideband M={M}")
    msps = best_rate(wr.process, xd, xd.shape[-1], dev, rounds, iters, 120.0)
    line = _emit(f"wideband_{M}ch_throughput", msps,
                 decode_ratio=round(good / len(active), 3))
    return StageResult([line], (lanes,), [msps])


def main_gateway(n_channels: int = 256, sfs=GATEWAY_SFS, rounds: int = 5, iters: int = 5,
                 device=None) -> StageResult:
    """``bench.py --gateway`` (``bench.py:94-180``): the multi-SF gateway
    (``pool=48``, bfloat16 channel planes) on :func:`gateway_capture`:
    ``gateway_{M}ch_{len(sfs)}sf_throughput``."""
    dev = resolve_device(device)
    M = n_channels
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    gw = MultiSFWidebandReceiver(cfg, M, sfs=sfs, pool=48, plane_dtype=torch.bfloat16,
                                 device=dev, **_KW)
    x, expect = gateway_capture(gw, dev)
    xd = pack_iq(x, device=dev)
    del x
    lanes, hit = gateway_gate(gw.process(xd), expect, f"gateway M={M}")
    msps = best_rate(gw.process, xd, xd.shape[-1], dev, rounds, iters, 120.0)
    line = _emit(f"gateway_{M}ch_{len(sfs)}sf_throughput", msps,
                 decode_ratio=round(hit / max(1, len(expect)), 3),
                 demod_contexts=M * len(sfs))
    return StageResult([line], (lanes,), [msps])


def main_plan_gateway(plan: str = "EU868", sfs=GATEWAY_SFS, rounds: int = 5, iters: int = 5,
                      device=None) -> StageResult:
    """``bench.py --plan-gateway`` (``bench.py:183-264``): the plan gateway
    (``pool=24``, float32, EU868 at 868.0 MHz / 2 Msps, US915 at 903.0 MHz
    / 8 Msps) on :func:`plan_capture`:
    ``plan_gateway_{plan}_{len(sfs)}sf_throughput``."""
    dev = resolve_device(device)
    center, rate = PLAN_GEOMS.get(plan.upper(), EU868_GEOM)
    gw = PlanGateway(plan, center, rate, sfs=sfs, pool=24, device=dev, **_KW)
    x, expect = plan_capture(gw, dev)
    xd = pack_iq(x, device=dev)
    del x
    lanes, hit = plan_gate(gw.process(xd), expect, f"plan gateway {plan}")
    msps = best_rate(gw.process, xd, xd.shape[-1], dev, rounds, iters, 120.0)
    line = _emit(f"plan_gateway_{plan.lower()}_{len(sfs)}sf_throughput", msps,
                 decode_ratio=round(hit / max(1, len(expect)), 3), channels=len(gw.channels))
    return StageResult([line], (lanes,), [msps])


def main_wideband_full(n_channels: int = 1024, rounds: int = 5, iters: int = 5,
                       device=None) -> StageResult:
    """``bench.py --wideband-full`` (``bench.py:267-347``): the PFB receiver
    with ``pool = M + M // 8`` and bfloat16 channel planes on
    :func:`full_occupancy_capture`, gated with no candidate dropped:
    ``wideband_{M}ch_full_occupancy_throughput``."""
    dev = resolve_device(device)
    M = n_channels
    cfg, x, active = full_occupancy_capture(M, dev)
    xd = pack_iq(x, device=dev)
    del x
    wr = WidebandReceiver(cfg, M, pool=M + M // 8, plane_dtype=torch.bfloat16, device=dev,
                          **_KW)
    lanes, good, n_dropped = wideband_gate(wr.process(xd), active,
                                           f"wideband M={M} full occupancy", no_drops=True)
    msps = best_rate(wr.process, xd, xd.shape[-1], dev, rounds, iters, 120.0)
    line = _emit(f"wideband_{M}ch_full_occupancy_throughput", msps,
                 decode_ratio=round(good / M, 3), n_dropped=n_dropped)
    return StageResult([line], (lanes,), [msps])


# ----------------------------------------------------------------- command

def device_banner(device: torch.device) -> str:
    """The card's name and ``nvidia-smi``'s name and power limit for it;
    on the CPU, a line that says so."""
    if device.type != "cuda":
        return "device: cpu (a host run: its rates are no device metric)"
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return (f"device: {torch.cuda.get_device_name(device)}; "
            f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")


def run_all(value, no_bf16: bool, device: torch.device) -> int:
    """Every stage in ``bench.py``'s order, each in its own process under
    its time limit, the dense stage last (with ``value`` channels and
    ``no_bf16``); builds the kernels first on the card. Returns 1 and
    names each stage that failed or ran out of time, else 0."""
    if device.type == "cuda":
        from .ops._build import build

        build("det_metrics", "pfb_fir", "lag_rows", "fused_chan")
    dense = ["--dense-only", *([value] if value else []), *(["--no-bf16"] if no_bf16 else [])]
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    stages = (*STAGES, (dense, DENSE_TIMEOUT_S))
    failed = []
    for flags, limit in stages:
        cmd = [sys.executable, "-m", "lora_tpu_torch.bench", *flags, "--device", str(device)]
        sys.stdout.flush()
        try:
            rc = subprocess.run(cmd, timeout=limit, check=False, env=env).returncode
        except subprocess.TimeoutExpired:
            failed.append(f"{' '.join(flags)}: timed out after {limit:.0f} s")
            continue
        if rc != 0:
            failed.append(f"{' '.join(flags)}: exit code {rc}")
    if failed:
        print(f"bench: FAIL: {len(failed)} of {len(stages)} stages: {'; '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m lora_tpu_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    stage = p.add_mutually_exclusive_group()
    for flag in ("--wideband", "--wideband-full", "--gateway", "--plan-gateway",
                 "--dense-only"):
        stage.add_argument(flag, action="store_true")
    p.add_argument("value", nargs="?", default=None,
                   help="the stage's channel count (wideband 1024, gateway 256, dense 64) "
                        "or plan (EU868)")
    p.add_argument("--no-bf16", action="store_true", help="dense: no bfloat16 line")
    p.add_argument("--device", default=None,
                   help="cuda (default: the card; raises without one) or cpu")
    return p


def cli_main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    v = args.value
    if args.wideband:
        stage, kw = main_wideband, dict(n_channels=int(v or 1024))
    elif args.wideband_full:
        stage, kw = main_wideband_full, dict(n_channels=int(v or 1024))
    elif args.gateway:
        stage, kw = main_gateway, dict(n_channels=int(v or 256))
    elif args.plan_gateway:
        stage, kw = main_plan_gateway, dict(plan=v or "EU868")
    elif args.dense_only:
        stage, kw = main, dict(n_channels=int(v or 64), bf16=not args.no_bf16)
    else:
        return run_all(v, args.no_bf16, device)
    print(device_banner(device), file=sys.stderr, flush=True)
    try:
        stage(device=device, **kw)
    except GateFailure as e:
        print(f"bench: FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
