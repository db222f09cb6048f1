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
:class:`MultiSFWidebandReceiver` is the gateway form: every channel at
every spreading factor from one PFB pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .channelizer import PolyphaseChannelizer, pfb_channel_freqs
from .config import LoRaConfig
from .device import resolve_device
from .io.frames import Frame, PhyHeader
from .ops.xfer import pack_iq
from .rx.dense import DenseReceiver
from .rx.frontend import multi_sf_detection_metrics


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


class _Channelized:
    """What both wideband receivers share: the PFB at ``num_channels *
    chan_config.samp_rate``, the active channels, the plane dtype, and the
    packing of host input (subclasses give the tailroom ``_pad``)."""

    def __init__(self, chan_config: LoRaConfig, num_channels: int, active_channels,
                 plane_dtype, device):
        self.cfg = chan_config
        self.M = int(num_channels)
        self.wide_rate = self.M * chan_config.samp_rate
        self.device = resolve_device(device)
        self.pfb = PolyphaseChannelizer.for_lora(
            self.wide_rate, self.M, chan_config.bandwidth, device=self.device)
        self.plane_dtype = torch.float32 if plane_dtype is None else plane_dtype
        if self.plane_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"plane_dtype must be float32 or bfloat16, not {plane_dtype}")
        self.active = (np.arange(self.M) if active_channels is None
                       else np.asarray(list(active_channels), dtype=np.int32))
        self._subset = (None if len(self.active) == self.M
                        else torch.as_tensor(self.active, dtype=torch.long, device=self.device))
        self.channel_freqs = pfb_channel_freqs(self.wide_rate, self.M)

    def _channel_planes(self, xf: torch.Tensor) -> torch.Tensor:
        """The active channels' planes ``[n_active, 2, n_out]``."""
        cp = self.pfb.planes(xf, out_dtype=self.plane_dtype)   # [M, 2, n_out]
        return cp if self._subset is None else cp[self._subset]

    def process(self, x):
        """``x``: host complex wideband IQ ``[L]``, host packed float32
        ``[2, L]``, or a tensor of planes. Host complex input is padded by
        one packet region of wideband samples (``_pad``) so channel-rate
        tails keep a full decode region."""
        if isinstance(x, torch.Tensor):
            return self.process_planes(x.to(self.device))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            xf = pack_iq(np.pad(x.astype(np.complex64), (0, self._pad)), device=self.device)
        else:
            xf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        return self.process_planes(xf)


class WidebandReceiver(_Channelized):
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
        super().__init__(chan_config, num_channels, active_channels, plane_dtype, device)
        self.rx = DenseReceiver(chan_config, device=self.device, **dense_kwargs)
        self.pool = pool
        self._pad = self.rx.pkt_samples * self.M

    def process_planes(self, xf: torch.Tensor):
        """Packed wideband planes ``[2, L]`` on the receiver's device ->
        ``DenseResult [n_active, P]``, or ``PooledResult [pool]`` when
        ``pool`` is set."""
        cp = self._channel_planes(xf)
        if self.pool is not None:
            return self.rx.process_pooled_planes(cp, self.pool)
        return self.rx.process_planes(cp)

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


class MultiSFWidebandReceiver(_Channelized):
    """Gateway receive: every channel x every spreading factor of a
    wideband capture on the card, as a LoRaWAN gateway listens.

    The PFB runs once and its channel planes feed one
    :class:`~lora_tpu_torch.rx.dense.DenseReceiver` per SF, each with its
    own global candidate pool of ``pool`` lanes. With
    ``shared_detection`` (the default) the detection metrics of every SF
    come from one multi-lag pass over the planes (every SF's symbol is a
    whole number of the smallest SF's), where each SF would otherwise read
    the planes once; ``False`` runs the per-SF detection instead (the A/B
    control). ``low_snr`` receivers use the dechirp metric, which the
    multi-lag pass does not give, so any of them opts the whole bank out of
    the shared pass, as JAX's gateway does. A candidate raised on the wrong
    SF's grid fails that SF's SFD search or header decode, so :meth:`run`
    needs no cross-SF arbitration.

    ``chan_config`` carries everything but the SF; ``sfs`` lists the SFs
    (duplicates dropped, order kept; none raises ``ValueError``).
    ``active_channels``, ``plane_dtype`` and ``device`` as for
    :class:`WidebandReceiver`; ``dense_kwargs`` go to every SF's receiver.
    :meth:`process` pads host complex input by the largest SF's packet
    region at the wideband rate (``max_pkt_samples * M``), so channel-rate
    tails keep a full decode region at every SF, and gives ``{sf:
    PooledResult}``.
    """

    def __init__(
        self,
        chan_config: LoRaConfig,
        num_channels: int,
        sfs: Sequence[int] = (7, 8, 9, 10, 11, 12),
        pool: int = 16,
        active_channels: Optional[Sequence[int]] = None,
        plane_dtype=None,
        shared_detection: bool = True,
        device=None,
        **dense_kwargs,
    ):
        if not sfs:
            raise ValueError("sfs must name at least one spreading factor")
        super().__init__(chan_config, num_channels, active_channels, plane_dtype, device)
        self.sfs = tuple(dict.fromkeys(int(s) for s in sfs))
        self.pool = int(pool)
        self.rxs: Dict[int, DenseReceiver] = {
            sf: DenseReceiver(dataclasses.replace(chan_config, sf=sf), device=self.device,
                              **dense_kwargs)
            for sf in self.sfs}
        self.shared_detection = bool(shared_detection)
        self._pad = self.max_pkt_samples * self.M

    @property
    def max_pkt_samples(self) -> int:
        """The largest SF's packet region (channel-rate samples)."""
        return max(rx.pkt_samples for rx in self.rxs.values())

    def process_planes(self, xf: torch.Tensor) -> Dict[int, object]:
        """Packed wideband planes ``[2, L]`` on the receiver's device ->
        ``{sf: PooledResult [pool]}``. With the shared detection the
        multi-lag detection and every SF's Phase B read the channelizer's
        planes where they lie (a view with a padded row pitch): no copy.
        The per-SF detection (``shared_detection=False``, or a ``low_snr``
        bank) reads contiguous planes, so that path copies them once for
        all SFs."""
        cp = self._channel_planes(xf)
        if self.shared_detection and not any(rx.low_snr for rx in self.rxs.values()):
            metrics = multi_sf_detection_metrics(
                cp, {sf: rx.sps for sf, rx in self.rxs.items()})
        else:
            cp = cp.contiguous()
            metrics = dict.fromkeys(self.sfs)
        return {sf: rx.process_pooled_planes(cp, self.pool, metrics=metrics[sf])
                for sf, rx in self.rxs.items()}

    def run(self, x) -> List[Frame]:
        """Decode; frames carry the channel index, its frequency and the SF
        they decoded at (``tap_header.sf``), sorted by channel and sample
        index."""
        results = self.process(x)
        frames: List[Frame] = []
        for sf in self.sfs:
            frames.extend(_frames_from_pooled(results[sf], self.active, self.rxs[sf].cfg,
                                              self.channel_freqs))
        frames.sort(key=lambda f: (f.channel, f.sample_index))
        return frames
