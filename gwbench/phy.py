"""LoRa PHY frame encoding: PHYPayload bytes -> symbol values.

A frozen copy of the port's transmit chain (``lora_tpu_torch/tx/
modulator.encode_frame_symbols`` with the helpers of ``ops/bits.py``,
``ops/hamming.py``, ``io/frames.py`` and the CR 4/5 whitening table of
``tables.py``), cut to what the benchmark sends: explicit header, payload
CRC on, any coding rate, no low-data-rate optimisation. It lives here so
that the traffic stays what it is when the program changes, and nothing
in this package imports the program to make its inputs.

On air (explicit header)::

    [8 x upchirp] [2 x sync upchirp] [2.25 x downchirp]
    [8 header-block symbols at SF-2 bits] [payload symbols at SF bits]
"""

from __future__ import annotations

import math
import struct

import numpy as np

PREAMBLE_SYMBOLS = 8
MAC_CRC_SIZE = 2

# CR 4/5-4/6 payload whitening keystream, the first 96 bytes of the
# reference's lib/tables.h:38-40 (a 31-byte payload needs 80)
_WHITEN_CR56 = np.array([
    0xff, 0xff, 0x2d, 0xff, 0x78, 0xff, 0x30, 0x2e, 0x00, 0x2e, 0x12, 0x3c, 0x14, 0x28, 0x0a, 0x30,
    0x36, 0x00, 0x1e, 0x12, 0x2e, 0x14, 0x3c, 0x0a, 0x28, 0x36, 0x30, 0x1e, 0x12, 0x2e, 0x06, 0x3c,
    0x0c, 0x28, 0x3a, 0x30, 0x24, 0x12, 0x18, 0x06, 0x30, 0x0c, 0x00, 0x3a, 0x00, 0x24, 0x00, 0x18,
    0x00, 0x30, 0x12, 0x00, 0x14, 0x00, 0x18, 0x00, 0x30, 0x00, 0x12, 0x12, 0x06, 0x14, 0x1e, 0x18,
    0x3c, 0x30, 0x28, 0x12, 0x30, 0x06, 0x12, 0x1e, 0x14, 0x3c, 0x18, 0x28, 0x22, 0x30, 0x14, 0x12,
    0x0a, 0x14, 0x36, 0x18, 0x1e, 0x22, 0x3c, 0x14, 0x28, 0x0a, 0x30, 0x36, 0x00, 0x1e, 0x00, 0x3c,
], dtype=np.uint8)
_SHUFFLE = (5, 0, 1, 2, 4, 3, 6, 7)


def mac_crc(data: bytes) -> bytes:
    """The LoRa payload CRC-16 (CCITT polynomial 0x1021, initial 0) over
    ``data[:-2]``, XORed with its last two bytes, little-endian."""
    crc = 0
    for byte in data[:-2]:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    if len(data) >= 2:
        crc ^= data[-1] ^ (data[-2] << 8)
    elif len(data) == 1:
        crc ^= data[-1]
    return struct.pack("<H", crc)


def _hamming84(nibbles: np.ndarray) -> np.ndarray:
    """Codeword bits (LSB first) ``p1 d0 d1 d2 p2 d3 p3 p4``."""
    d = [(nibbles >> i) & 1 for i in range(4)]
    p1, p2 = d[1] ^ d[2] ^ d[3], d[0] ^ d[1] ^ d[2]
    p3, p4 = d[0] ^ d[1] ^ d[3], d[0] ^ d[2] ^ d[3]
    return (p1 | (d[0] << 1) | (d[1] << 2) | (d[2] << 3) | (p2 << 4) | (d[3] << 5)
            | (p3 << 6) | (p4 << 7)).astype(np.uint8)


def header_checksum(length: int, cr: int, crc: bool) -> tuple:
    """The PHY header's checksum nibbles ``(msn, lsn)``."""
    n0, n1, n2 = (length >> 4) & 0xF, length & 0xF, ((cr & 0x7) << 1) | int(crc)

    def b(v, i):
        return (v >> i) & 1

    c4 = b(n0, 3) ^ b(n0, 2) ^ b(n0, 1) ^ b(n0, 0)
    c3 = b(n0, 3) ^ b(n1, 3) ^ b(n1, 2) ^ b(n1, 1) ^ b(n2, 0)
    c2 = b(n0, 2) ^ b(n1, 3) ^ b(n1, 0) ^ b(n2, 3) ^ b(n2, 1)
    c1 = b(n0, 1) ^ b(n1, 2) ^ b(n1, 0) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    c0 = b(n0, 0) ^ b(n1, 1) ^ b(n2, 3) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    return c4, (c3 << 3) | (c2 << 2) | (c1 << 1) | c0


def payload_symbols(sf: int, cr: int, n_bytes: int) -> int:
    """Payload symbols of an explicit-header frame of ``n_bytes`` (CRC
    included), no low-data-rate optimisation."""
    blk = 4 + cr
    return int(math.ceil(n_bytes * 8.0 * (blk / 4.0) / sf / blk)) * blk


def codeword_capacity(sf: int, max_symbols: int) -> int:
    """Payload codewords a receiver lane of ``max_symbols`` payload symbols
    carries: the header block's spare rows plus every whole CR 4/5 block
    (the arithmetic of ``rx/dense.codeword_capacity``)."""
    return sf - 2 - 5 + (max_symbols // 5) * sf


def _shuffle(words: np.ndarray) -> np.ndarray:
    out = words & 0
    for j, dst in enumerate(_SHUFFLE):
        out = out | (((words >> j) & 1) << dst)
    return out


def _interleave(rows: np.ndarray, ppm: int, n_words: int) -> np.ndarray:
    """Rows ``[..., ppm]`` of ``n_words``-bit codewords -> ``n_words`` words
    of ``ppm`` bits: word ``i`` gathers bit ``i`` of every row, rotated
    right by ``i``."""
    i = np.arange(n_words)
    bits = (rows.astype(np.int64)[..., :, None] >> i) & 1          # [..., ppm, n_words]
    w = (bits << np.arange(ppm)[:, None]).sum(axis=-2)              # [..., n_words]
    k = i % ppm
    return ((w >> k) | (w << (ppm - k))) & ((1 << ppm) - 1)


def _gray_to_bin(x: np.ndarray, nbits: int) -> np.ndarray:
    y, shift = x, 1
    while shift < nbits:
        y = y ^ (x >> shift)
        x = y
        shift *= 2
    return y


def frame_symbols(sf: int, cr: int, phy_payload: bytes) -> np.ndarray:
    """The data symbols of one explicit-header, CRC-on frame: 8 header
    block values in ``[0, 2^(sf-2))`` then the payload values in ``[0,
    2^sf)``, as int64 (before the chirp shift of :func:`symbol_shifts`)."""
    full = bytes(phy_payload) + mac_crc(bytes(phy_payload))
    nib = np.frombuffer(full, dtype=np.uint8)
    pay_cw = _hamming84(np.stack([nib & 0xF, nib >> 4], axis=-1).reshape(-1))
    msn, lsn = header_checksum(len(phy_payload), cr, True)
    hdr_cw = _hamming84(np.array([(len(phy_payload) >> 4) & 0xF, len(phy_payload) & 0xF,
                                  ((cr & 0x7) << 1) | 1, msn, lsn], dtype=np.uint8))
    hdr_slots = sf - 2 - 5
    n_blocks = payload_symbols(sf, cr, len(full)) // (4 + cr)
    total = hdr_slots + n_blocks * sf
    if total < len(pay_cw) or total > len(_WHITEN_CR56) or cr > 2:
        raise ValueError(f"frame of {len(full)} bytes at SF{sf} CR 4/{4 + cr} is out of range")
    padded = np.zeros(total, dtype=np.uint8)
    padded[:len(pay_cw)] = pay_cw
    whitened = padded ^ _WHITEN_CR56[:total]
    hdr_rows = _shuffle(np.concatenate([hdr_cw, whitened[:hdr_slots]]))
    pay_rows = _shuffle(whitened[hdr_slots:]).reshape(n_blocks, sf)
    hdr = _gray_to_bin(_interleave(hdr_rows, sf - 2, 8), sf - 2)
    pay = _gray_to_bin(_interleave(pay_rows, sf, 4 + cr).reshape(-1), sf)
    return np.concatenate([hdr, pay]).astype(np.int64)


def symbol_shifts(sf: int, sync_word: int, data: np.ndarray) -> np.ndarray:
    """Chirp shifts, in bins of ``2^sf``, of every upchirp of a frame: the
    preamble (0), the two sync symbols (each nibble times 8) and the data
    (``4 v + 1`` in the header block, ``v + 1`` after)."""
    n = 1 << sf
    sync = [((sync_word >> 4) & 0xF) * 8 % n, (sync_word & 0xF) * 8 % n]
    hdr = 4 * data[:8] + 1
    pay = (data[8:] + 1) % n
    return np.concatenate([np.zeros(PREAMBLE_SYMBOLS, np.int64), sync, hdr, pay])
