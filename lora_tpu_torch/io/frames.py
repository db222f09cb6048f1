"""LoRaTap / LoRaPHY wire formats and frame assembly.

Replicates reference ``include/lora/loratap.h:35-55`` and
``include/lora/loraphy.h:25-32`` packed structs, the frame assembly of
``decoder_impl::msg_lora_frame`` (``lib/decoder_impl.cc:588-609``), and the
per-layer stripping of ``message_socket_sink_impl::msg_send_udp``
(``lib/message_socket_sink_impl.cc:93-122``).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

from ..config import MAC_CRC_SIZE

LORATAP_HEADER_SIZE = 15
LORAPHY_HEADER_SIZE = 3

# Layer selectors (reference include/lora/message_socket_sink.h:695)
LORATAP = 0
LORAPHY = 1
LORAMAC = 2


@dataclass
class PhyHeader:
    """Decoded LoRa PHY header (reference loraphy.h bitfield layout).

    Byte 0: ``length``; byte 1: ``crc_msn``(b0-3) | ``has_mac_crc``(b4) |
    ``cr``(b5-7); byte 2: ``crc_lsn``(b0-3) | ``reserved``(b4-7).
    """

    length: int = 0
    crc_msn: int = 0
    has_mac_crc: int = 0
    cr: int = 0
    crc_lsn: int = 0
    reserved: int = 0

    @classmethod
    def from_bytes(cls, b) -> "PhyHeader":
        b = bytes(b)
        return cls(
            length=b[0],
            crc_msn=b[1] & 0x0F,
            has_mac_crc=(b[1] >> 4) & 0x1,
            cr=(b[1] >> 5) & 0x7,
            crc_lsn=b[2] & 0x0F,
            reserved=(b[2] >> 4) & 0x0F,
        )

    def to_bytes(self) -> bytes:
        return bytes(
            [
                self.length & 0xFF,
                (self.crc_msn & 0x0F) | ((self.has_mac_crc & 1) << 4) | ((self.cr & 0x7) << 5),
                (self.crc_lsn & 0x0F) | ((self.reserved & 0x0F) << 4),
            ]
        )


@dataclass
class LoRaTapHeader:
    """LoRaTap v0 header (big-endian fields, reference loratap.h:48-55)."""

    lt_version: int = 0
    lt_padding: int = 0
    lt_length: int = 0
    frequency: int = 0
    bandwidth: int = 0
    sf: int = 0
    packet_rssi: int = 0
    max_rssi: int = 0
    current_rssi: int = 0
    snr: int = 0
    sync_word: int = 0

    def to_bytes(self) -> bytes:
        return struct.pack(
            ">BBHIBBBBBBB",
            self.lt_version, self.lt_padding, self.lt_length,
            self.frequency, self.bandwidth, self.sf,
            self.packet_rssi, self.max_rssi, self.current_rssi, self.snr,
            self.sync_word,
        )

    @classmethod
    def from_bytes(cls, b) -> "LoRaTapHeader":
        return cls(*struct.unpack(">BBHIBBBBBBB", bytes(b[:LORATAP_HEADER_SIZE])))


def snr_to_loratap(snr: float) -> int:
    """``(uint8)(10*log10(snr) + 0.5)`` — reference lib/decoder_impl.cc:597.

    Out-of-range estimates (zero/negative noise floor on synthetic
    captures gives snr of 0 or inf) clamp instead of overflowing.
    """
    if snr <= 0.0 or math.isnan(snr):
        return 0
    if math.isinf(snr):
        return 0xFF
    return int(10.0 * math.log10(snr) + 0.5) & 0xFF


@dataclass
class Frame:
    """One decoded LoRa frame: loratap ++ loraphy ++ payload bytes.

    The reference builds exactly this buffer in ``msg_lora_frame`` and
    publishes it as a PMT blob on the ``frames`` port; here it is a plain
    object with byte-level accessors per layer.
    """

    phy_header: PhyHeader
    payload: bytes                      # payload incl. MAC CRC if present
    snr: float = 0.0
    tap_header: LoRaTapHeader = field(default_factory=LoRaTapHeader)
    channel: int = 0                    # channel index (multi-channel rx)
    sample_index: int = -1              # stream position where decode finished
    cfo: float = 0.0                    # estimated carrier freq offset (Hz)
    # seam-dedup conflict resolution (streaming receivers): a CRC-passing
    # re-decode replacing an earlier corrupt seam-clipped emission is
    # flagged so consumers that already saw the corrupt frame can
    # correlate the correction instead of counting a duplicate
    dedup_replacement: bool = False
    replaces: int = -1                  # sample_index of the retracted frame

    def __post_init__(self):
        self.tap_header.snr = snr_to_loratap(self.snr)

    @property
    def crc_ok(self):
        """Validate the MAC payload CRC-16 — a check the reference
        explicitly does NOT implement (reference README.md:10-14).

        Returns ``None`` when the frame carries no MAC CRC, else bool.
        """
        if not self.phy_header.has_mac_crc or len(self.payload) <= MAC_CRC_SIZE:
            return None
        data = self.payload[: -MAC_CRC_SIZE]
        return mac_crc(data) == self.payload[-MAC_CRC_SIZE:]

    def to_bytes(self, layer: int = LORATAP) -> bytes:
        """Serialize, stripping headers per the requested layer
        (reference message_socket_sink_impl.cc:97-116)."""
        buf = self.tap_header.to_bytes() + self.phy_header.to_bytes() + self.payload
        if layer == LORATAP:
            return buf
        if layer == LORAPHY:
            return buf[LORATAP_HEADER_SIZE:]
        if layer == LORAMAC:
            end = len(buf) - MAC_CRC_SIZE * self.phy_header.has_mac_crc
            return buf[LORATAP_HEADER_SIZE + LORAPHY_HEADER_SIZE : end]
        return buf

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Frame":
        """Dissect a LORATAP-layer buffer back into a Frame (the
        ``dissect_packet`` counterpart of ``build_packet``, reference
        include/lora/utilities.h:406-416); round-trips ``to_bytes()``. The
        tap header's snr byte is kept as received."""
        buf = bytes(buf)
        head = LORATAP_HEADER_SIZE + LORAPHY_HEADER_SIZE
        if len(buf) < head:
            raise ValueError(f"buffer too short for loratap+phy headers ({len(buf)} bytes)")
        tap = LoRaTapHeader.from_bytes(buf)
        wire_snr = tap.snr
        f = cls(phy_header=PhyHeader.from_bytes(buf[LORATAP_HEADER_SIZE:head]),
                payload=buf[head:], snr=10.0 ** (wire_snr / 10.0) if wire_snr else 0.0,
                tap_header=tap)
        f.tap_header.snr = wire_snr
        return f

    @property
    def mac_payload(self) -> bytes:
        return self.to_bytes(LORAMAC)

    def payload_hex(self, layer: int = LORAMAC) -> str:
        return self.to_bytes(layer).hex()


def header_checksum_nibbles(length: int, cr: int, has_mac_crc: bool) -> tuple:
    """LoRa PHY header checksum ``(msn, lsn)``.

    The reference documents the bit ordering in ``utilities.h:396-404`` but
    never verifies it (``header_checksum`` returns true); the tx side here
    computes the standard checksum so generated traces carry realistic
    headers. Verified against the reference demo trace header
    ``04 90 40`` (len=4, cr=4, crc=1 -> msn 0x0, lsn 0x4). The parity
    equations live in ``ops/bits.header_checksum_nibbles`` — shared with
    the rx verification so the two sides cannot diverge.
    """
    from ..ops.bits import header_checksum_nibbles as _nibbles

    msn, lsn = _nibbles(length, cr, 1 if has_mac_crc else 0)
    return int(msn), int(lsn)


def mac_crc(payload: bytes) -> bytes:
    """LoRa payload CRC-16 (CCITT poly 0x1021, init 0), little-endian.

    The CRC covers ``payload[:-2]`` and is XORed with the last two payload
    bytes (``de ad be ef`` -> ``80 ec``). Note the reference demo trace
    carries ``70 0d`` (reference README.md:81-86), which matches no
    standard CRC-16 variant; the reference decoder never *checks* CRCs at
    all (README.md:10-14), so this framework uses the standard LoRa
    convention for tx and exposes ``Frame.crc_ok`` on rx.
    """
    crc = 0
    for byte in payload[:-2]:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    if len(payload) >= 2:
        crc ^= payload[-1] ^ (payload[-2] << 8)
    elif len(payload) == 1:
        crc ^= payload[-1]
    return struct.pack("<H", crc)
