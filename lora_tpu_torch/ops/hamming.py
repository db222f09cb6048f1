"""Hamming(8,4) FEC as 16/256-entry lookup tables.

The port's own copy of the tables that replace liquid-dsp's
``fec_create(LIQUID_FEC_HAMMING84)`` in the reference
(``lib/decoder_impl.cc:112-117,654-665``). Codeword bit layout (LSB
first): ``p1 d0 d1 d2 p2 d3 p3 p4`` with ``p1 = d1^d2^d3``,
``p2 = d0^d1^d2``, ``p3 = d0^d1^d3``, ``p4 = d0^d2^d3`` (reference
``include/lora/utilities.h:257-264``). Decoding corrects any single bit
error through the syndrome table of ``hamming_decode_soft_byte``
(``utilities.h:288-339``).

The tables are numpy; the decode tail moves them to its device once.
"""

from __future__ import annotations

import numpy as np


def _bit(v, i):
    return (v >> i) & 1


def _encode_nibble(v: int) -> int:
    d0, d1, d2, d3 = _bit(v, 0), _bit(v, 1), _bit(v, 2), _bit(v, 3)
    p1 = d1 ^ d2 ^ d3
    p2 = d0 ^ d1 ^ d2
    p3 = d0 ^ d1 ^ d3
    p4 = d0 ^ d2 ^ d3
    return (p1 | (d0 << 1) | (d1 << 2) | (d2 << 3) | (p2 << 4) | (d3 << 5)
            | (p3 << 6) | (p4 << 7))


def _build_tables():
    enc = np.array([_encode_nibble(v) for v in range(16)], dtype=np.uint8)
    # syndrome -> flipped-bit-position (reference utilities.h:318-319)
    H = np.array([0x0, 0x0, 0x4, 0x0, 0x6, 0x0, 0x0, 0x2,
                  0x7, 0x0, 0x0, 0x3, 0x0, 0x5, 0x1, 0x0], dtype=np.uint8)
    dec = np.zeros(256, dtype=np.uint8)
    for v in range(256):
        p1, p2, p3, p4 = _bit(v, 0), _bit(v, 4), _bit(v, 6), _bit(v, 7)
        p1c = _bit(v, 2) ^ _bit(v, 3) ^ _bit(v, 5)
        p2c = _bit(v, 1) ^ _bit(v, 2) ^ _bit(v, 3)
        p3c = _bit(v, 1) ^ _bit(v, 2) ^ _bit(v, 5)
        p4c = _bit(v, 1) ^ _bit(v, 3) ^ _bit(v, 5)
        syndrome = ((p1 != p1c) | ((p2 != p2c) << 1) | ((p3 != p3c) << 2)
                    | ((p4 != p4c) << 3))
        w = v ^ (1 << int(H[syndrome])) if syndrome else v
        dec[v] = (_bit(w, 1) | (_bit(w, 2) << 1) | (_bit(w, 3) << 2)
                  | (_bit(w, 5) << 3))
    return enc, dec


HAMMING84_ENCODE_LUT, HAMMING84_DECODE_LUT = _build_tables()


def hamming84_encode(nibbles) -> np.ndarray:
    """nibble array -> codeword byte array (tx side, numpy)."""
    return HAMMING84_ENCODE_LUT[np.asarray(nibbles, dtype=np.uint8) & 0x0F]
