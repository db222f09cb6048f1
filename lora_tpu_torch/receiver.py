"""User-facing receiver facade.

Mirrors the reference hier block ``lora.lora_receiver``
(python/lora_receiver.py:30): channelization (optional) -> conjugate
(optional, downlink) -> decoder, with the decoder's CFO ``control``
feedback applied to the channelizer's mixer (the reference wires it
through controller_impl, whose publisher is disabled,
lib/decoder_impl.cc:774; :meth:`LoRaReceiver.apply_cfo` is the explicit
form of ``channelizer_impl::apply_cfo`` :68-71).

Engines:

- ``"golden"``: the numpy sequential reference model
  (:class:`~lora_tpu_torch.rx.golden.GoldenReceiver`), the default;
- ``"dense"``: the batched two-phase receiver
  (:class:`~lora_tpu_torch.rx.dense.DenseReceiver`) on the facade's device;
- ``"parity"``: the jitted state machine of the JAX package, not ported
  (``NotImplementedError``).

Channelization runs on the facade's device (``None``: the card): one
channel through :func:`~lora_tpu_torch.channelizer.freq_xlating_fir`,
several through :func:`~lora_tpu_torch.channelizer.channelize_list`. The
dense engine takes the channel streams where they lie; the golden engine
copies them to the host. Unlike the reference (which channelizes only
``channel_list[0]``, lib/channelizer_impl.cc:47), every listed channel is
extracted and decoded.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .channelizer import channelize_list, freq_xlating_fir, lora_channel_taps
from .config import LoRaConfig
from .device import resolve_device
from .io.frames import Frame


class LoRaReceiver:
    """``LoRaReceiver(samp_rate, center_freq, channel_list, bandwidth,
    sf, ...)``: JAX's facade and signature, plus ``device`` (``None``: the
    card, raising without one; ``"cpu"`` for the CPU). ``engine_kwargs``
    go to the engine's receiver; ``low_snr="auto"`` (dense engine) decodes
    with the reference-parity gates first and retries an empty capture
    through the coherent low-SNR receiver, built at the first such
    capture."""

    def __init__(
        self,
        samp_rate: float,
        center_freq: float,
        channel_list: Sequence[float],
        bandwidth: float,
        sf: int,
        implicit: bool = False,
        cr: int = 4,
        crc: bool = True,
        reduced_rate: bool = False,
        conj: bool = False,
        decimation: int = 1,
        disable_channelization: bool = False,
        disable_drift_correction: bool = False,
        engine: str = "golden",
        auto_cfo: bool = False,
        device=None,
        **engine_kwargs,
    ):
        if engine == "parity":
            raise NotImplementedError(
                "the parity engine (JAX's JaxReceiver) is not ported: ROADMAP.md "
                "section 1, item 5")
        if engine not in ("golden", "dense"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        self.auto_cfo = auto_cfo
        self.samp_rate = samp_rate
        self.center_freq = center_freq
        self.channel_list = list(channel_list) if channel_list else [center_freq]
        self.bandwidth = bandwidth
        # non-integer decimation (e.g. RTL-SDR 1.024 Msps -> 1 Msps) takes
        # the fractional-resampler path, as in the reference (:59-62)
        self.decimation = (
            int(decimation) if float(decimation) == int(decimation)
            else float(decimation)
        )
        self.decimation = max(1, self.decimation)
        if not isinstance(self.decimation, int) and not disable_channelization:
            raise ValueError(
                "fractional decimation requires disable_channelization=True "
                "(the reference's fractional_resampler path; its channelizer "
                "FIR likewise only takes integer decimation)"
            )
        self.disable_channelization = disable_channelization
        self.engine = engine
        self._cfo = 0.0

        self.config = LoRaConfig(
            sf=sf,
            cr=cr,
            bandwidth=bandwidth,
            samp_rate=samp_rate / self.decimation,
            implicit=implicit,
            crc=crc,
            reduced_rate=reduced_rate,
            conj=conj,
            disable_drift_correction=disable_drift_correction,
        )
        self._taps = lora_channel_taps(samp_rate, bandwidth)
        self._decoders = None
        self._engine_kwargs = dict(engine_kwargs)
        # low_snr="auto" (dense engine): the reference-parity gates first;
        # a capture that yields NOTHING is retried through the coherent
        # low-SNR receiver. Only empty captures pay the second pass.
        # Implicit-header configs stay on the parity gates: their end of
        # frame is an energy threshold against the preamble window
        # (lib/decoder_impl.cc:356-357,861-864), noise-dominated at the
        # SNRs where the coherent mode matters.
        self._auto_low_snr = (
            engine == "dense"
            and self._engine_kwargs.get("low_snr") == "auto"
        )
        if self._auto_low_snr:
            self._engine_kwargs.pop("low_snr")
            self._coherent = None  # built lazily on the first empty capture

    # ---- control plane (reference controller/channelizer feedback) ----

    def apply_cfo(self, cfo: float) -> None:
        """Accumulate a CFO correction into the channelizer mixer
        (reference channelizer_impl.cc:68-71)."""
        self._cfo += cfo

    # ---- decode -------------------------------------------------------

    def _make_decoder(self):
        if self.engine == "golden":
            from .rx.golden import GoldenReceiver

            return GoldenReceiver(self.config)
        from .rx.dense import DenseReceiver

        return DenseReceiver(self.config, device=self.device, **self._engine_kwargs)

    def _run_streams(self, dec, streams) -> List[Frame]:
        """Decode every channel stream; ``frame.channel`` is its index. The
        dense engine decodes several channels in one call."""
        if self.engine == "dense" and len(streams) > 1:
            return dec.run(streams)
        frames: List[Frame] = []
        for ci, s in enumerate(streams):
            if self.engine == "golden" and isinstance(s, torch.Tensor):
                s = s.cpu().numpy()
            for f in dec.run(s):
                f.channel = ci
                frames.append(f)
        return frames

    def _receive_coherent(self, streams) -> List[Frame]:
        """The low_snr="auto" second pass: coherent detection and SFD on
        the channel streams already made."""
        if self._coherent is None:
            from .rx.dense import DenseReceiver

            kw = dict(self._engine_kwargs)
            kw.pop("demod_method", None)  # low_snr mode is fft-engine only
            try:
                self._coherent = DenseReceiver(self.config, low_snr=True,
                                               device=self.device, **kw)
            except ValueError:
                # the geometry cannot host the fold matrices (sps * n_bins
                # past the budget): auto mode stays single-pass
                self._coherent = False
        if self._coherent is False:
            return []
        return self._run_streams(self._coherent, streams)

    def _channelize(self, samples: np.ndarray):
        """The channel streams of one capture: a list of host arrays
        (``disable_channelization``), a one-element list of a complex
        tensor (one channel), or a complex tensor ``[C, m]``."""
        if self.disable_channelization:
            # the reference's fractional resampler path
            # (python/lora_receiver.py:59-62); integer decimation strides
            if isinstance(self.decimation, int):
                return [samples[:: self.decimation]]
            from .channelizer import fractional_resampler

            return [fractional_resampler(samples, self.decimation)]
        offsets = [f - self.center_freq + self._cfo for f in self.channel_list]
        if len(offsets) == 1:
            return [freq_xlating_fir(samples, self._taps, offsets[0], self.samp_rate,
                                     self.decimation, device=self.device)]
        return channelize_list(samples, self._taps, offsets, self.samp_rate,
                               self.decimation, device=self.device)

    def receive(self, samples: np.ndarray) -> List[Frame]:
        """Channelize + decode one capture; returns all decoded frames
        (``frame.channel`` = index into ``channel_list``)."""
        samples = np.asarray(samples, dtype=np.complex64)
        if self._decoders is None:
            self._decoders = self._make_decoder()
        streams = self._channelize(samples)
        frames = self._run_streams(self._decoders, streams)
        if self._auto_low_snr and not frames and not self.config.implicit:
            frames = self._receive_coherent(streams)
        for f in frames:
            # the LoRaTap radio-metadata fields (the reference zeroes them
            # but snr, lib/decoder_impl.cc:592-600; loratap consumers
            # expect them filled)
            f.tap_header.frequency = int(self.channel_list[f.channel])
            f.tap_header.sf = self.config.sf
            f.tap_header.sync_word = self.config.sync_word
        if self.auto_cfo and frames:
            # close the reference's decoder->controller->channelizer loop
            # (python/lora_receiver.py:66, lib/controller_impl.cc:52-57):
            # retune the mixer by the median frame CFO for the next capture
            self.apply_cfo(float(np.median([f.cfo for f in frames])))
        return frames

    # ---- reference API surface (python/lora_receiver.py:80-97) --------

    def get_sf(self) -> int:
        return self.config.sf

    def set_sf(self, sf: int) -> None:
        # runtime SF changes are unsupported in the reference too
        # (lib/decoder_impl.cc:905-909)
        import warnings

        warnings.warn("setting the spreading factor during execution is not supported")

    def get_center_freq(self) -> float:
        return self.center_freq

    def set_center_freq(self, center_freq: float) -> None:
        self.center_freq = center_freq
