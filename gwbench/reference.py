"""The plain reference that decides ``correct``: plain PyTorch, no part of
the program.

- Channel planes: the channelizer's function worked out again in float64
  from the capture block: mix channel ``c`` to DC with ``exp(-2j pi f_c m
  / fs)`` (``m`` from the block's first sample), filter with the channel
  filter, keep every ``D``-th output. The filter is GNU Radio's
  ``firdes.low_pass`` with a Hamming window (53 dB), cutoff ``bw/2 +
  15 kHz``, transition ``chan_rate / 4``, rounded to float32 as the
  design states: a frozen copy of ``lora_tpu_torch/channelizer.
  firdes_low_pass`` and of the defaults of ``plans.PlanGateway``.
- Frames: the uplinks the benchmark sent. A decoded frame is right when
  its channel, SF and PHYPayload are an uplink's, its CRC bytes are the
  CRC of that payload, and its start lies within
  ``[-1, +3]`` symbols of the uplink's start at the channel rate (the
  receiver reports the detection window after the preamble's first).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import phy


def channel_taps(samp_rate: float, bandwidth: float, chan_rate: float) -> np.ndarray:
    """The channel filter, float32 (``firdes.low_pass``, Hamming)."""
    cutoff, transition = bandwidth / 2.0 + 15000.0, chan_rate / 4.0
    ntaps = int(53.0 / (22.0 * (transition / samp_rate)))
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * (n + m) / (ntaps - 1))
    w0 = 2.0 * np.pi * cutoff / samp_rate
    n_safe = np.where(n == 0, 1.0, n)
    taps = np.where(n == 0, w0 / np.pi, np.sin(n_safe * w0) / (n_safe * np.pi)) * win
    return (taps / np.sum(taps)).astype(np.float32)


def channel_slice(block: torch.Tensor, offset_hz: float, samp_rate: float, taps,
                  decim: int, t0: int, n: int) -> torch.Tensor:
    """Outputs ``t0 .. t0+n-1`` of one channel of the capture ``block``
    (planes ``[2, L]``), complex ``[n]``, in float64."""
    K = len(taps)
    lo, hi = t0 * decim, (t0 + n - 1) * decim + K
    dev = block.device
    m = torch.arange(lo, hi, dtype=torch.float64, device=dev)
    ph = -2.0 * math.pi * torch.remainder(m * (offset_hz / samp_rate), 1.0)
    h = torch.as_tensor(np.asarray(taps, np.float64), device=dev)
    xr, xi = block[0, lo:hi].to(torch.float64), block[1, lo:hi].to(torch.float64)
    cr, ci = torch.cos(ph), torch.sin(ph)
    mr, mi = xr * cr - xi * ci, xr * ci + xi * cr
    fr = mr.unfold(0, K, decim)[:n] @ h
    fi = mi.unfold(0, K, decim)[:n] @ h
    return torch.complex(fr, fi)


def slice_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error of a slice of channel planes ``[2, n]`` (or complex
    ``[n]``) against the reference's complex ``[n]``, over the
    reference's RMS."""
    if not got.is_complex():
        got = torch.complex(got[0].to(torch.float64), got[1].to(torch.float64))
    rms = float(torch.sqrt(torch.mean(ref.abs() ** 2)))
    return float((got.to(torch.complex128) - ref).abs().max()) / max(rms, 1e-300)


def chan_start(u, taps_len: int, decim: int) -> float:
    """Where uplink ``u``'s first sample lands at the channel rate: output
    ``n`` is centred on input ``n D + (K - 1) / 2``."""
    return (u.start - (taps_len - 1) / 2.0) / decim


def compare_frames(frames: List, uplinks: List, cfg, taps_len: int, decim: int) -> Dict:
    """One block's decoded frames (``channel``, ``sf``, ``sample_index``,
    ``payload`` with its CRC) against the uplinks sent in it. Returns
    the counts ``missed`` (uplinks no right frame carries), ``wrong``
    (frames that match no uplink, or match one already matched) and the
    worst start offset of the right frames, in symbols."""
    left = {}
    for u in uplinks:
        left.setdefault((u.channel, u.sf, u.phy), []).append(u)
    wrong, worst = 0, 0.0
    matched = 0
    bad = []
    for f in frames:
        sf = int(f.sf)
        pay = bytes(f.payload)
        data, crc = pay[:-phy.MAC_CRC_SIZE], pay[-phy.MAC_CRC_SIZE:]
        cands = left.get((int(f.channel), sf, data), [])
        sps = (1 << sf) * int(round(cfg["chan_rate"] / cfg["bandwidth"]))
        hit = None
        if crc == phy.mac_crc(data):
            for u in cands:
                off = (f.sample_index - chan_start(u, taps_len, decim)) / sps
                if -1.0 <= off <= 3.0:
                    hit = (u, off)
                    break
        if hit is None:
            wrong += 1
            near = [u for u in uplinks if u.channel == int(f.channel) and u.sf == sf]
            bad.append(dict(channel=int(f.channel), sf=sf, crc=crc == phy.mac_crc(data),
                            payload=any(u.phy == data for u in near),
                            start_sym=[round((f.sample_index - chan_start(u, taps_len, decim))
                                             / sps, 3) for u in near]))
            continue
        cands.remove(hit[0])
        matched += 1
        worst = max(worst, abs(hit[1]))
    lost = [u for us in left.values() for u in us]
    return {"missed": len(uplinks) - matched, "wrong": wrong, "start_sym": worst,
            "lost": lost, "bad": bad}
