"""LoRaWAN regional channel plans: gateway receive on real deployments.

The reference takes a ``channel_list`` of absolute frequencies but only
ever extracts the first one (reference ``lib/channelizer_impl.cc:47``).
:class:`PlanGateway` decodes every in-band channel of a plan at every
spreading factor.

Why not the PFB: LoRaWAN plans space channels 200 kHz apart, and a
critically-sampled polyphase filterbank forces channel rate = spacing; at
200 ksps the LoRa symbol is ``2^sf * 200/125`` samples, not an integer
for any SF, so plan channels can never sit on a PFB grid the decoder can
consume. A plan of 8-64 channels is the regime of the batched
frequency-translating FIR (:mod:`lora_tpu_torch.channelizer`): its cost
scales with the channel count, which is small, and every channel lands at
a decoder-legal rate (default 250 ksps). Dense channel grids on the
PFB-legal spacing stay with
:class:`~lora_tpu_torch.wideband.MultiSFWidebandReceiver`.

Plan constants are the published LoRaWAN regional parameters (uplink
125 kHz channels): EU868 = the 3 mandatory + 5 conventional extension
channels; US915 = 64 uplink channels at 200 kHz spacing; AU915 mirrors
US915 shifted to 915.2 MHz.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import tracing
from .channelizer import (channelize_list_planes_factored, firdes_low_pass,
                          fused_mix_tables, fused_ramp_factors, make_fused_fir_matrix,
                          make_mixer_factors)
from .config import LoRaConfig
from .device import resolve_device
from .io.frames import Frame
from .ops.cuda_kernels import fused_channelize_kernel
from .ops.xfer import pack_iq
from .rx.dense import DenseReceiver
from .rx.frontend import multi_sf_detection_metrics
from .wideband import _frames_from_pooled

# Uplink 125 kHz channel center frequencies [Hz].
EU868 = tuple(868.1e6 + 0.2e6 * i for i in range(3)) + tuple(
    867.1e6 + 0.2e6 * i for i in range(5)
)
US915 = tuple(902.3e6 + 0.2e6 * i for i in range(64))
AU915 = tuple(915.2e6 + 0.2e6 * i for i in range(64))

PLANS = {"EU868": EU868, "US915": US915, "AU915": AU915}


class PlanGateway:
    """Every in-band channel of a LoRaWAN regional plan x every SF.

    ``plan``: a plan name (``"EU868"``/``"US915"``/``"AU915"``) or a
    sequence of absolute channel frequencies [Hz]. Channels outside the
    captured band ``center_freq +- (samp_rate/2 - chan_rate/2)`` are
    skipped. ``samp_rate`` must be an integer multiple ``decim`` of
    ``chan_rate`` (the per-channel rate; 250 ksps default). ``sync_word``
    defaults to 0x34 (public LoRaWAN). ``pool``: the lanes of each SF's
    global candidate pool (default ``max(8, 2 * channels)``).
    ``plane_dtype``: ``None`` keeps the channelizer's float32 planes,
    ``torch.bfloat16`` casts them before the dense stages.

    ``fused`` (default ``True``): the channelizer is the fused mix + FIR +
    decimate (:func:`~lora_tpu_torch.ops.cuda_kernels.
    fused_channelize_kernel`, the hand-written kernel on the card); ``False``
    takes the factored path (mixer from two small tables, then the
    decimating FIR), the A/B control. Nothing chooses between them by
    geometry or device. The fused channelizer's block-independent tables
    are built once, on the device: ``_g2``, the folded FIR matrix its plain
    version (the CPU) takes, and ``_mix``, the zero-padded real taps and
    the phase table the CUDA kernel takes (it mixes per channel, then
    applies the real taps); the ramp factors (fused) or mixer factors
    (factored) are cached on the device by block length, two lengths at
    most.

    ``device``: ``None`` is the card. ``dense_kwargs`` go to every SF's
    :class:`~lora_tpu_torch.rx.dense.DenseReceiver`.
    """

    def __init__(
        self,
        plan,
        center_freq: float,
        samp_rate: float,
        chan_rate: float = 250e3,
        sfs: Sequence[int] = (7, 8, 9, 10, 11, 12),
        bandwidth: float = 125e3,
        cr: int = 4,
        crc: bool = True,
        implicit: bool = False,
        sync_word: int = 0x34,
        pool: Optional[int] = None,
        transition_hz: Optional[float] = None,
        plane_dtype=None,
        fused: bool = True,
        device=None,
        **dense_kwargs,
    ):
        if isinstance(plan, str):
            try:
                plan = PLANS[plan.upper()]
            except KeyError:
                raise ValueError(
                    f"unknown plan {plan!r}; known: {sorted(PLANS)}") from None
        decim = int(round(samp_rate / chan_rate))
        if abs(samp_rate - decim * chan_rate) > 1e-6 or decim < 1:
            raise ValueError(f"samp_rate {samp_rate} is not an integer multiple of "
                             f"chan_rate {chan_rate}")
        if plane_dtype not in (None, torch.float32, torch.bfloat16):
            raise TypeError(f"plane_dtype must be float32 or bfloat16, not {plane_dtype}")
        self.center_freq = float(center_freq)
        self.samp_rate = float(samp_rate)
        self.chan_rate = float(chan_rate)
        self.decim = decim
        guard = chan_rate / 2.0
        self.channels: List[float] = [
            float(f) for f in plan if abs(f - center_freq) <= samp_rate / 2.0 - guard]
        if not self.channels:
            raise ValueError(
                "no plan channel falls inside the captured band "
                f"[{(center_freq - samp_rate/2)/1e6:.3f}, "
                f"{(center_freq + samp_rate/2)/1e6:.3f}] MHz")
        self.offsets = np.asarray([f - center_freq for f in self.channels], dtype=np.float64)
        self.device = resolve_device(device)
        # channel filter: the reference cutoff (bw/2 + 15k,
        # lib/channelizer_impl.cc:46) with the transition relaxed to
        # chan_rate/4 (the reference's 10 kHz transition costs ~2000 taps
        # at 8 Msps for no decode benefit)
        self.taps = firdes_low_pass(
            1.0, samp_rate, bandwidth / 2.0 + 15000.0,
            transition_hz if transition_hz is not None else chan_rate / 4.0)
        self.cfg = LoRaConfig(sf=min(sfs), cr=cr, samp_rate=chan_rate, bandwidth=bandwidth,
                              crc=crc, implicit=implicit, sync_word=sync_word)
        self.sfs = tuple(dict.fromkeys(int(s) for s in sfs))
        self.pool = int(pool) if pool is not None else max(8, 2 * len(self.channels))
        self.rxs: Dict[int, DenseReceiver] = {
            sf: DenseReceiver(dataclasses.replace(self.cfg, sf=sf), device=self.device,
                              **dense_kwargs)
            for sf in self.sfs}
        # streaming-adapter surface
        self.active = np.arange(len(self.channels), dtype=np.int32)
        self.channel_freqs = np.asarray(self.channels, dtype=np.float64)
        self.plane_dtype = plane_dtype
        self.fused = bool(fused)
        # the ramp tables' output tile: the TPU kernel's, so its tables load
        # unchanged (the CUDA kernel reads any tile)
        self._fused_tile = 1024
        self._g2 = torch.as_tensor(
            make_fused_fir_matrix(self.offsets, samp_rate, self.taps, decim), device=self.device)
        self._mix = tuple(torch.as_tensor(t, device=self.device) for t in fused_mix_tables(
            self.offsets, samp_rate, self.taps, decim))
        self._tables = {}   # (kind, L) -> device tables, two entries at most

    @property
    def max_pkt_samples(self) -> int:
        """The largest SF's packet region (channel-rate samples)."""
        return max(rx.pkt_samples for rx in self.rxs.values())

    def _cached(self, key, build):
        if key not in self._tables:
            if len(self._tables) >= 2:
                self._tables.pop(next(iter(self._tables)))
            self._tables[key] = tuple(torch.as_tensor(t, device=self.device) for t in build())
        return self._tables[key]

    @tracing.spanned("lora.channelize")
    def channel_planes(self, xf: torch.Tensor) -> torch.Tensor:
        """Packed wideband planes ``[2, L]`` float32 on the gateway's device
        -> channel planes ``[C, 2, n_out]`` float32, ``n_out = (L -
        n_taps) // decim + 1``: the fused channelizer, or the factored one
        when ``fused`` is off."""
        L = xf.shape[-1]
        if self.fused:
            ramp = self._cached(("fused", L), lambda: fused_ramp_factors(
                self.offsets, self.samp_rate, self.decim, len(self.taps), L, self._fused_tile))
            return fused_channelize_kernel(xf, self._g2, ramp, self.decim, len(self.taps),
                                           self._mix)
        outer, inner = self._cached(("factored", L), lambda: make_mixer_factors(
            self.offsets, self.samp_rate, L))
        return channelize_list_planes_factored(xf, self.taps, outer, inner, self.decim)

    @tracing.spanned("lora.gateway")
    def process_planes(self, xf: torch.Tensor) -> Dict[int, object]:
        """Packed wideband planes ``[2, L]`` on the gateway's device ->
        ``{sf: PooledResult [pool]}``. The channel planes are computed once
        a call, cast to ``plane_dtype`` and made contiguous once, and
        shared by one multi-lag detection pass and every SF's stage. A bank
        with a ``low_snr`` receiver skips the shared pass (the multi-lag
        kernel gives the autocorrelation, not the dechirp metric): each SF
        detects on its own, as in JAX's gateway."""
        cp = self.channel_planes(xf)
        with tracing.span("lora.cast"):
            if self.plane_dtype is not None:
                cp = cp.to(self.plane_dtype)
            cp = cp.contiguous()
        if any(rx.low_snr for rx in self.rxs.values()):
            metrics = dict.fromkeys(self.sfs)
        else:
            metrics = multi_sf_detection_metrics(
                cp, {sf: rx.sps for sf, rx in self.rxs.items()})
        return {sf: rx.process_pooled_planes(cp, self.pool, metrics=metrics[sf])
                for sf, rx in self.rxs.items()}

    def process(self, x) -> Dict[int, object]:
        """``x``: host complex wideband IQ ``[L]``, host packed float32
        ``[2, L]``, or a tensor of planes (taken as it is, on the gateway's
        device) -> ``{sf: PooledResult}``. Host complex input is padded by
        the largest SF's packet region at the wideband rate
        (``max_pkt_samples * decim``), so tail packets keep a full decode
        region."""
        if isinstance(x, torch.Tensor):
            return self.process_planes(x.to(self.device))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            xf = pack_iq(np.pad(x.astype(np.complex64), (0, self.max_pkt_samples * self.decim)),
                         device=self.device)
        else:
            xf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        return self.process_planes(xf)

    def run(self, x) -> List[Frame]:
        """Decode; frames carry the plan channel index, its absolute
        frequency and the SF they decoded at, sorted by channel and sample
        index."""
        results = self.process(x)
        frames: List[Frame] = []
        idx = np.arange(len(self.channels))
        for sf in self.sfs:
            fs = _frames_from_pooled(results[sf], idx, self.rxs[sf].cfg,
                                     np.zeros(len(self.channels)))
            for f in fs:
                f.tap_header.frequency = int(self.channels[f.channel])
            frames.extend(fs)
        frames.sort(key=lambda f: (f.channel, f.sample_index))
        return frames
