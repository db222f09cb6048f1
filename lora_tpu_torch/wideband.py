"""Wideband full-band receiver: PFB channelizer + dense decode on the card.

The capability the reference lacks ("decoding multiple channels
simultaneously"; its channelizer extracts only ``channel_list[0]``,
lib/channelizer_impl.cc:47). One wideband capture at ``M * chan_rate`` is
split by the critically-sampled polyphase filterbank into ``M`` channel
planes, which the dense receiver decodes where they lie: the channel
planes never return to the host.

Channel ``c`` of the PFB sits at ``pfb_channel_freqs(samp_rate, M)[c]`` Hz
relative to the capture center; :meth:`WidebandReceiver.run` stamps each
frame with its channel index and center frequency.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .channelizer import PolyphaseChannelizer, pfb_channel_freqs
from .config import LoRaConfig
from .device import resolve_device
from .io.frames import Frame, PhyHeader
from .ops.xfer import pack_iq
from .rx.dense import DenseReceiver


def _frame(cfg: LoRaConfig, channel_freqs, chan: int, hdr, payload, snr,
           start, cfo) -> Frame:
    f = Frame(phy_header=PhyHeader.from_bytes(bytes(hdr)), payload=bytes(payload),
              snr=float(snr), channel=chan, sample_index=int(start), cfo=float(cfo))
    f.tap_header.frequency = int(abs(channel_freqs[chan]))
    f.tap_header.sf = cfg.sf
    f.tap_header.sync_word = cfg.sync_word
    return f


def _frames_from_pooled(res, active, cfg: LoRaConfig, channel_freqs) -> List[Frame]:
    """Host-side Frame extraction from a :class:`PooledResult`, in lane
    order."""
    valid = res.valid.cpu().numpy()
    chan = res.channel.cpu().numpy()
    pay, plen = res.payload.cpu().numpy(), res.length.cpu().numpy()
    hdr, snr = res.hdr.cpu().numpy(), res.snr.cpu().numpy()
    start, cfo = res.start.cpu().numpy(), res.cfo.cpu().numpy()
    return [_frame(cfg, channel_freqs, int(active[int(chan[g])]), hdr[g],
                   pay[g][: plen[g]], snr[g], start[g], cfo[g])
            for g in np.nonzero(valid)[0]]


class WidebandReceiver:
    """Decode every LoRa channel of a wideband capture on the card.

    ``chan_config``: the per-channel LoRa config; its ``samp_rate`` is the
    per-channel rate, and the wideband rate is ``num_channels *
    chan_config.samp_rate``. ``active_channels``: PFB channel indices to
    decode (default all); the PFB always computes the full bank.
    ``pool``: ``None`` decodes ``max_candidates`` lanes per channel
    (:meth:`DenseReceiver.process_planes`); an int decodes one global pool
    of that many lanes (:meth:`DenseReceiver.process_pooled_planes`, the
    scaling path for hundreds or thousands of channels). ``plane_dtype``:
    float32 (default) or bfloat16 channel planes between the PFB and the
    dense stage; bf16 halves their traffic at a ~40 dB quantization floor.
    ``device``: ``None`` is the card.
    """

    def __init__(
        self,
        chan_config: LoRaConfig,
        num_channels: int,
        active_channels: Optional[Sequence[int]] = None,
        pool: Optional[int] = None,
        plane_dtype=None,
        device=None,
        **dense_kwargs,
    ):
        self.cfg = chan_config
        self.M = int(num_channels)
        self.wide_rate = self.M * chan_config.samp_rate
        self.device = resolve_device(device)
        self.pfb = PolyphaseChannelizer.for_lora(
            self.wide_rate, self.M, chan_config.bandwidth, device=self.device)
        self.rx = DenseReceiver(chan_config, device=self.device, **dense_kwargs)
        self.pool = pool
        self.plane_dtype = torch.float32 if plane_dtype is None else plane_dtype
        if self.plane_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"plane_dtype must be float32 or bfloat16, not {plane_dtype}")
        self.active = (np.arange(self.M) if active_channels is None
                       else np.asarray(list(active_channels), dtype=np.int32))
        self._subset = (None if len(self.active) == self.M
                        else torch.as_tensor(self.active, dtype=torch.long, device=self.device))
        self.channel_freqs = pfb_channel_freqs(self.wide_rate, self.M)

    def process_planes(self, xf: torch.Tensor):
        """Packed wideband planes ``[2, L]`` on the receiver's device ->
        ``DenseResult [n_active, P]``, or ``PooledResult [pool]`` when
        ``pool`` is set."""
        cp = self.pfb.planes(xf, out_dtype=self.plane_dtype)   # [M, 2, n_out]
        if self._subset is not None:
            cp = cp[self._subset]
        if self.pool is not None:
            return self.rx.process_pooled_planes(cp, self.pool)
        return self.rx.process_planes(cp)

    def process(self, x):
        """``x``: host complex wideband IQ ``[L]``, host packed float32
        ``[2, L]``, or a tensor of planes. Host complex input is padded by
        one packet region of wideband samples (``pkt_samples * M``) so
        channel-rate tails keep a full decode region."""
        if isinstance(x, torch.Tensor):
            return self.process_planes(x.to(self.device))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            pad = self.rx.pkt_samples * self.M
            xf = pack_iq(np.pad(x.astype(np.complex64), (0, pad)), device=self.device)
        else:
            xf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        return self.process_planes(xf)

    def run(self, x) -> List[Frame]:
        """Decode; frames carry the PFB channel index and its frequency."""
        res = self.process(x)
        if self.pool is not None:
            return _frames_from_pooled(res, self.active, self.cfg, self.channel_freqs)
        valid = res.valid.cpu().numpy()
        pay, plen = res.payload.cpu().numpy(), res.length.cpu().numpy()
        hdr, snr = res.hdr.cpu().numpy(), res.snr.cpu().numpy()
        start, cfo = res.start.cpu().numpy(), res.cfo.cpu().numpy()
        return [_frame(self.cfg, self.channel_freqs, int(self.active[ci]), hdr[ci, k],
                       pay[ci, k][: plen[ci, k]], snr[ci, k], start[ci, k], cfo[ci, k])
                for ci in range(valid.shape[0]) for k in np.nonzero(valid[ci])[0]]


class MultiSFWidebandReceiver:
    """Every channel x every spreading factor of a wideband capture: not
    ported yet. It needs the multi-lag detection kernel (K3,
    ``lag_rows_pallas``) and the fft drift pass from SF11, which the port
    does not have."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiSFWidebandReceiver is not ported: it needs the multi-lag "
            "detection kernel K3 (lag_rows_pallas) and the fft drift pass (SF >= 11)")
