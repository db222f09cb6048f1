"""The benchmark's traffic: LoRaWAN uplinks in whole-band captures, made
on the device from ``--seed``.

A capture block is ``hop + halo`` wideband samples: white complex noise
of unit power, plus every uplink of the block, each synthesised sample by
sample from the continuous LoRa waveform at its channel's offset from the
capture centre. Every uplink starts inside the hop, so it lies whole in
the block (the halo is longer than any frame). The schedule of a block
is drawn on the host from ``(seed, block)``; the noise from a generator
on the device seeded the same way. Every seed gets the same number of
uplinks a block and the same count at each SF; the seed moves their
channels, times, payloads and impairments. Two parameters of a mix narrow
the draw: ``channels`` (``uniform``, the default, or ``distinct``: within
an SF a block's uplinks take distinct channels while they number at most
the channel count) and ``start_alignment`` (``free``, the default, any
real time, or ``window``: each start moved onto the receiver's window
grid of its SF, :func:`window_start`).

The pattern is ``lora_tpu_torch/bench.py``'s (``plan_capture``: synthesis
on the card from a seed), rewritten for LoRaWAN uplinks. The waveform is
the one ``lora_tpu_torch/tx/modulator.py`` samples (``ops/chirp.
build_ideal_chirps``: an upchirp sweeps ``-bw/2 .. bw/2`` over a symbol,
shift ``s`` starts it ``s`` bins in), made phase-continuous and sampled
in the device's own time, which a clock offset of ``drift_ppm`` stretches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import phy

CHUNK = 1 << 23           # samples synthesised per pass of one uplink


@dataclass(frozen=True)
class Uplink:
    channel: int           # index into the plan's channels
    sf: int
    start: float           # when the preamble starts, in wideband samples from the block's
                           # first (a real time: a transmitter keeps no receiver's clock)
    phy: bytes             # the PHYPayload (the CRC is added on air)
    snr_db: float          # over the 125 kHz channel bandwidth
    cfo_hz: float
    drift_ppm: float
    phase: float

    def symbols(self, cfg) -> int:
        """Symbols on air, the SFD's quarter counted as one."""
        n = len(self.phy) + phy.MAC_CRC_SIZE
        return phy.PREAMBLE_SYMBOLS + 2 + 3 + 8 + phy.payload_symbols(self.sf, cfg["cr"], n)

    def airtime_samples(self, cfg) -> int:
        """Wideband samples from the start to the last sample of the frame."""
        ts = (1 << self.sf) / cfg["bandwidth"]
        n_data = self.symbols(cfg) - phy.PREAMBLE_SYMBOLS - 2 - 3
        dur = (phy.PREAMBLE_SYMBOLS + 2 + 2.25 + n_data) * ts
        return int(math.ceil(dur * cfg["samp_rate"] / (1.0 + self.drift_ppm * 1e-6))) + 1


def sf_counts(n: int, mix: dict, sfs) -> dict:
    """``n`` uplinks split over ``sfs`` by the mix (renormalised over
    ``sfs``), by largest remainder: the same counts for every seed."""
    w = np.array([float(mix[str(sf)]) for sf in sfs])
    share = n * w / w.sum()
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return {sf: int(c) for sf, c in zip(sfs, counts)}


def frm_cap(cfg, sf: int, traffic) -> int:
    lo, hi = traffic["frm_payload_bytes"]
    return min(hi, int(cfg.get("frm_payload_max", {}).get(str(sf), hi)))


def block_seed(seed: int, block: int, stream: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(seed) >> 64, block, stream])


def window_start(start: float, sf: int, cfg, taps_len: int) -> float:
    """The first wideband start at or after ``start`` whose frame's first
    sample lands on a window edge of SF ``sf`` at the channel rate (output
    ``n`` is centred on input ``n D + (K - 1) / 2``)."""
    D = int(round(cfg["samp_rate"] / cfg["chan_rate"]))
    sym = (1 << sf) * int(round(cfg["chan_rate"] / cfg["bandwidth"])) * D
    c = (taps_len - 1) / 2.0
    return c + math.ceil((start - c) / sym) * sym


def schedule(cfg, traffic, seed: int, block: int) -> List[Uplink]:
    """The uplinks of one block, drawn from ``(seed, block)``: each on a
    channel (uniform, or distinct within its SF: a permutation, cycled),
    its start uniform over the hop past a two-symbol lead-in and moved onto
    its SF's window grid where the mix asks for it, redrawn while the frame
    would overlap another on its channel or start past the hop."""
    from .reference import channel_taps

    channels = traffic.get("channels", "uniform")
    alignment = traffic.get("start_alignment", "free")
    if channels not in ("uniform", "distinct") or alignment not in ("free", "window"):
        raise ValueError(f"unknown channels {channels!r} or start_alignment {alignment!r}")
    taps_len = len(channel_taps(cfg["samp_rate"], cfg["bandwidth"], cfg["chan_rate"]))
    rng = np.random.default_rng(block_seed(seed, block, 0))
    C = len(cfg["channels_hz"])
    hop = int(cfg["hop_samples"])
    n = int(round(traffic["uplinks_per_s"] * hop / cfg["samp_rate"]))
    counts = sf_counts(n, traffic["sf_mix"], cfg["sfs"])
    lead = 2 * (1 << max(cfg["sfs"])) * int(cfg["samp_rate"] / cfg["bandwidth"])
    busy = {c: [] for c in range(C)}
    out = []
    snr_lo, snr_hi = traffic["snr_db"]
    order = [sf for sf in sorted(counts, reverse=True) for _ in range(counts[sf])]
    perm = {sf: np.concatenate([rng.permutation(C) for _ in range(-(-counts[sf] // C))])
            for sf in counts} if channels == "distinct" else None
    for i, sf in enumerate(order):
        c = int(perm[sf][order[:i].count(sf)]) if perm else int(rng.integers(C))
        lo, _ = traffic["frm_payload_bytes"]
        frm = int(rng.integers(lo, frm_cap(cfg, sf, traffic) + 1))
        body = rng.integers(0, 256, traffic["mac_overhead_bytes"] - 1 + frm, dtype=np.uint8)
        u = Uplink(channel=c, sf=sf, start=0, phy=bytes([traffic["mhdr"]]) + body.tobytes(),
                   snr_db=float(rng.uniform(snr_lo, snr_hi)),
                   cfo_hz=float(rng.uniform(-1.0, 1.0) * traffic["cfo_hz"]),
                   drift_ppm=float(rng.uniform(-1.0, 1.0) * traffic["drift_ppm"]),
                   phase=float(rng.uniform(0.0, 2 * math.pi)))
        n_air = u.airtime_samples(cfg)
        for _ in range(10000):
            s = float(rng.uniform(lead, hop))
            if alignment == "window":
                s = window_start(s, sf, cfg, taps_len)
            if s < hop and all(s + n_air <= a or b <= s for a, b in busy[c]):
                break
        else:
            raise RuntimeError(f"no room on channel {c} for an SF{sf} uplink")
        busy[c].append((s, s + n_air))
        out.append(Uplink(**{**u.__dict__, "start": s}))
    return sorted(out, key=lambda u: (u.start, u.channel))


def _psi(tau: torch.Tensor, ts: float, bw: float) -> torch.Tensor:
    """Phase of the upchirp at device time ``tau`` into its symbol."""
    return math.pi * bw * tau * (tau / ts - 1.0)


def add_uplink(planes: torch.Tensor, u: Uplink, cfg) -> None:
    """Add one uplink's waveform to the packed planes ``[2, L]`` (float32,
    in place): float64 phases, reduced modulo 2 pi, cast once."""
    fs, bw = float(cfg["samp_rate"]), float(cfg["bandwidth"])
    N = 1 << u.sf
    ts = N / bw
    dev = planes.device
    data = phy.frame_symbols(u.sf, cfg["cr"], u.phy)
    shifts = torch.as_tensor(phy.symbol_shifts(u.sf, cfg["sync_word"], data),
                             dtype=torch.float64, device=dev) * (ts / N)
    n_up = shifts.shape[0]
    n_pre = phy.PREAMBLE_SYMBOLS + 2
    t_end = (n_pre + 2.25 + (n_up - n_pre)) * ts
    stretch = 1.0 + u.drift_ppm * 1e-6
    amp = math.sqrt(10.0 ** (u.snr_db / 10.0) * bw / fs)
    a = (cfg["channels_hz"][u.channel] - cfg["center_hz"]) / fs
    n0 = math.ceil(u.start)
    n_len = min(u.airtime_samples(cfg), planes.shape[-1] - n0)
    two_pi = 2.0 * math.pi
    for c0 in range(0, n_len, CHUNK):
        k = torch.arange(c0, min(c0 + CHUNK, n_len), dtype=torch.float64, device=dev)
        tau = (k + (n0 - u.start)) * (stretch / fs)
        sfd = (tau >= n_pre * ts) & (tau < (n_pre + 2.25) * ts)
        after = tau >= (n_pre + 2.25) * ts
        j = torch.where(after, n_pre + torch.floor((tau - (n_pre + 2.25) * ts) / ts),
                        torch.floor(tau / ts)).clamp(0, n_up - 1)
        t0 = torch.where(after, (n_pre + 2.25) * ts + (j - n_pre) * ts, j * ts)
        off = shifts[j.long()]
        tl = tau - t0
        up = _psi(torch.remainder(tl + off, ts), ts, bw) - _psi(off, ts, bw)
        tl_sfd = tau - n_pre * ts
        down = -_psi(tl_sfd - torch.floor(tl_sfd / ts) * ts, ts, bw)
        ph = torch.where(sfd, down, up)
        carrier = two_pi * torch.remainder(a * (k + n0), 1.0)
        ph = ph + carrier + two_pi * u.cfo_hz * (tau / stretch) + u.phase
        ph = torch.remainder(ph, two_pi)
        live = (tau < t_end).to(torch.float64) * amp
        sl = slice(n0 + c0, n0 + c0 + k.shape[0])
        planes[0, sl] += (torch.cos(ph) * live).to(torch.float32)
        planes[1, sl] += (torch.sin(ph) * live).to(torch.float32)


def make_block(cfg, uplinks: List[Uplink], length: int, seed: int, block: int,
               device) -> torch.Tensor:
    """One capture block ``[2, length]`` float32 on ``device``: unit-power
    complex noise from a device generator seeded by ``(seed, block)``,
    then every uplink."""
    g = torch.Generator(device=device)
    g.manual_seed(int(block_seed(seed, block, 1).generate_state(1, np.uint32)[0]))
    planes = torch.randn((2, length), generator=g, device=device, dtype=torch.float32)
    planes.mul_(math.sqrt(0.5))
    for u in uplinks:
        add_uplink(planes, u, cfg)
    return planes
