"""LoRa receiver/transmitter configuration.

A single frozen dataclass mirrors the reference's three config tiers
(block constructor parameters, ``python/loraconfig.py``, and the SigMF
``lora:*`` metadata keys) — see reference ``include/lora/decoder.h:705``,
``python/loraconfig.py:1-31``.

All derived quantities follow the formulas in reference
``lib/decoder_impl.cc:79-91`` exactly, so that a config constructed from the
same parameters yields identical samples-per-symbol / bins / decimation.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


MAC_CRC_SIZE = 2  # reference include/lora/utilities.h:29
MAX_PWR_QUEUE_SIZE = 4  # reference include/lora/utilities.h:30


def payload_symbol_count(sf: int, cr: int, reduced_rate: bool, payload_length: int) -> int:
    """Payload symbol budget for an explicit-header packet.

    ``payload_length`` includes MAC CRC bytes. ``cr`` is the *decoded*
    header coding rate (0..4 after the reference's clamp at
    lib/decoder_impl.cc:834). Formula from lib/decoder_impl.cc:842-847.
    """
    redundancy = 2 if reduced_rate else 0
    symbols_per_block = cr + 4
    bits_needed = float(payload_length) * 8.0
    symbols_needed = bits_needed * (symbols_per_block / 4.0) / float(sf - redundancy)
    blocks_needed = int(math.ceil(symbols_needed / symbols_per_block))
    return blocks_needed * symbols_per_block


@dataclass(frozen=True)
class LoRaConfig:
    """Static (trace-time) configuration of one LoRa channel.

    Parameters mirror ``lora.decoder.make(samp_rate, bandwidth, sf, implicit,
    cr, crc, reduced_rate, disable_drift_correction)`` (reference
    ``lib/decoder_impl.cc:41-44``) plus the receiver-level options of
    ``python/lora_receiver.py:30``.
    """

    sf: int                       # spreading factor, 6..13
    cr: int = 4                   # coding rate 4/(4+cr), cr in 1..4
    bandwidth: float = 125e3      # LoRa channel bandwidth [Hz]
    samp_rate: float = 1e6        # IQ sample rate fed to the decoder [Hz]
    implicit: bool = False        # implicit header mode
    crc: bool = True              # payload carries a 2-byte MAC CRC
    reduced_rate: bool = False    # low data rate optimisation (payload at SF-2)
    prlen: int = 8                # preamble length in symbols (tx / SigMF meta)
    conj: bool = False            # downlink: conjugate input first
    disable_drift_correction: bool = False
    # Radio sync word. Default 0 => sync symbols are plain upchirps.
    # Non-zero sync words (0x12 RN2483 / 0x34 LoRaWAN) produce shifted
    # sync upchirps; the receivers recognise them in FIND_SFD by their
    # demodulated shift relative to the preamble (CFO-proof) and hold
    # alignment through them — the reference algorithm instead mis-chases
    # them at SF>=11 (its still-upchirp resync branch,
    # lib/decoder_impl.cc:801-803, fine-syncs a shifted sync symbol
    # against the unshifted upchirp, corrupting every payload bin) and
    # burns correlation-fail budget on them at SF<=10. The recognition is
    # shift-agnostic, so the rx decodes any sync word without being
    # configured for it; this field drives the tx modulator and is
    # recorded in SigMF metadata / LoRaTap headers.
    sync_word: int = 0x00

    def __post_init__(self):
        if not (6 <= self.sf <= 13):
            # reference lib/decoder_impl.cc:57-61
            raise ValueError(f"spreading factor must be in [6, 13], got {self.sf}")
        if not (1 <= self.cr <= 4):
            raise ValueError(f"coding rate index must be in [1, 4], got {self.cr}")
        if self.sf == 6 and not self.implicit:
            # real LoRa SF6 is implicit-header only; the reference's explicit
            # SF6 path indexes past the ppm=4 deinterleave rows (see README
            # conformance notes) — reject instead of corrupting
            raise ValueError("SF6 requires implicit-header mode")
        if self.samples_per_symbol % self.number_of_bins != 0:
            raise ValueError(
                "samp_rate must yield an integer decimation factor: "
                f"samples_per_symbol={self.samples_per_symbol}, bins={self.number_of_bins}"
            )

    # ---- derived quantities (reference lib/decoder_impl.cc:79-91) ----

    @property
    def symbols_per_second(self) -> float:
        return self.bandwidth / (1 << self.sf)

    @property
    def bits_per_second(self) -> float:
        return self.sf * (4.0 / (4.0 + self.cr)) / (1 << self.sf) * self.bandwidth

    @property
    def bits_per_symbol(self) -> float:
        return self.bits_per_second / self.symbols_per_second

    @property
    def samples_per_symbol(self) -> int:
        return int(self.samp_rate / self.symbols_per_second)

    @property
    def delay_after_sync(self) -> int:
        return self.samples_per_symbol // 4

    @property
    def number_of_bins(self) -> int:
        return 1 << self.sf

    @property
    def number_of_bins_hdr(self) -> int:
        return 1 << (self.sf - 2)

    @property
    def decim_factor(self) -> int:
        return self.samples_per_symbol // self.number_of_bins

    # ---- helpers ----

    def payload_symbol_count(self, payload_length: int) -> int:
        """Number of payload symbols for an explicit-header packet.

        ``payload_length`` must already include the MAC CRC bytes if present.
        """
        return payload_symbol_count(self.sf, self.cr, self.reduced_rate, payload_length)

    def replace(self, **kw) -> "LoRaConfig":
        return dataclasses.replace(self, **kw)

    @property
    def cr_string(self) -> str:
        return f"4/{4 + self.cr}"

    @classmethod
    def from_cr_string(cls, sf: int, cr: str, **kw) -> "LoRaConfig":
        """Build from a ``"4/x"`` coding-rate string (reference python/loraconfig.py:6)."""
        return cls(sf=sf, cr=int(cr.rpartition("/")[2]) - 4, **kw)

    def file_repr(self, freq: float = 868.1e6) -> str:
        """Trace filename stem (reference python/loraconfig.py:12-18)."""
        s = f"{freq / 1e6:g}-sf{self.sf:d}-cr{self.cr:d}-bw{self.bandwidth / 1e3:g}"
        if self.crc:
            s += "-crc"
        if self.implicit:
            s += "-imp"
        return s

    def string_repr(self, freq: float = 868.1e6) -> str:
        """Human-readable config line (reference python/loraconfig.py:20-30)."""
        return (
            f"{freq / 1e6:g} MHz, SF {self.sf:d}, CR {self.cr_string}, "
            f"BW {self.bandwidth / 1e3:g} kHz, prlen {self.prlen:d}, "
            f"crc {'on' if self.crc else 'off'}, "
            f"implicit {'on' if self.implicit else 'off'}"
        )
