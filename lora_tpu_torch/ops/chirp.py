"""Ideal chirp synthesis and instantaneous-frequency extraction.

Reference ``lib/decoder_impl.cc``:

- ``build_ideal_chirps`` (:141-175): ``chirp(t) = (1+1j) *
  exp(+-j*2*pi*t*(f0 + T*t))`` with ``f0 = bw/2`` and ``T =
  -0.5*bw*symbols_per_second``; the ``(1+1j)`` amplitude is kept so every
  correlation threshold keeps its meaning. The phase is built in float64
  on the host and only the result is cast to complex64.
- ``instantaneous_frequency`` (:224-244): phase difference with +-pi
  unwrapping; output ``i`` holds ``phase[i+1]-phase[i]`` and the last
  element repeats the one before; ``instantaneous_phase`` (:246-257)
  sums those steps.

The tables are built with numpy (host, once per receiver);
:func:`instantaneous_frequency` is the torch form used on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import LoRaConfig


def build_ideal_chirps(config: LoRaConfig):
    """``(upchirp, downchirp)`` complex64 numpy, ``samples_per_symbol`` long."""
    sps = config.samples_per_symbol
    fs = config.samp_rate
    T = -0.5 * config.bandwidth * config.symbols_per_second
    f0 = config.bandwidth / 2.0
    t = np.arange(sps, dtype=np.float64) / fs
    phase = 2.0 * np.pi * t * (f0 + T * t)
    cmx = 1.0 + 1.0j
    down = (cmx * np.exp(1j * phase)).astype(np.complex64)
    up = (cmx * np.exp(-1j * phase)).astype(np.complex64)
    return up, down


def instantaneous_frequency_np(samples: np.ndarray) -> np.ndarray:
    """Host (numpy) :func:`instantaneous_frequency`, for the tables."""
    phase = np.angle(samples)
    d = phase[..., 1:] - phase[..., :-1]
    d = np.where(d > np.pi, d - 2.0 * np.pi, d)
    d = np.where(d < -np.pi, d + 2.0 * np.pi, d)
    return np.concatenate([d, d[..., -1:]], axis=-1).astype(np.float32)


def instantaneous_frequency(samples: torch.Tensor) -> torch.Tensor:
    """complex64 ``[..., n]`` -> float32 ``[..., n]``:
    ``out[k] = wrap(angle(x[k+1]) - angle(x[k]))``, ``out[-1] = out[-2]``."""
    phase = torch.angle(samples)
    d = phase[..., 1:] - phase[..., :-1]
    d = torch.where(d > math.pi, d - 2.0 * math.pi, d)
    d = torch.where(d < -math.pi, d + 2.0 * math.pi, d)
    return torch.cat([d, d[..., -1:]], dim=-1).to(torch.float32)


def instantaneous_phase(samples: torch.Tensor) -> torch.Tensor:
    """Unwrapped phase (reference lib/decoder_impl.cc:246-257): complex64
    ``[..., n]`` -> float32 ``[..., n]``, ``angle(x[0])`` plus the running
    sum of the wrapped phase steps."""
    phase = torch.angle(samples)
    d = phase[..., 1:] - phase[..., :-1]
    d = torch.where(d > math.pi, d - 2.0 * math.pi, d)
    d = torch.where(d < -math.pi, d + 2.0 * math.pi, d)
    return torch.cat([phase[..., :1], phase[..., :1] + torch.cumsum(d, dim=-1)],
                     dim=-1).to(torch.float32)


def tiled_upchirp_ifreq(config: LoRaConfig) -> np.ndarray:
    """ifreq of four concatenated upchirps: the reference's three-symbol
    bank (:170-174) plus one more symbol, so that a lag search at the top
    bin reads values the periodic chirp defines instead of running off
    the end of the bank."""
    up, _ = build_ideal_chirps(config)
    return instantaneous_frequency_np(np.concatenate([up, up, up, up]))
