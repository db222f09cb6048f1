"""Bit-twiddling for the LoRa integer decode chain.

The port's own copy of the reference helpers (``include/lora/utilities.h``
``rotl`` :96, ``select_bits`` :209, ``swap_nibbles`` :274, and the gray /
shuffle steps of ``lib/decoder_impl.cc``). Every function is written with
Python's bit operators only, so one body serves numpy integer arrays (the
host-side tables and the modulator) and torch integer tensors (the
batched decode tail on the device).
"""

from __future__ import annotations

from ..tables import EXTRACT_DATA_INDICES, SHUFFLE_PATTERN


def gray_decode(x, nbits: int):
    """Inverse of the rx gray step ``word = bin ^ (bin >> 1)`` (reference
    lib/decoder_impl.cc:512) for ``nbits``-wide values (tx side)."""
    y = x
    shift = 1
    while shift < nbits:
        y = y ^ (x >> shift)
        x = y
        shift *= 2
    return y


def rotl(bits, count: int, size: int):
    """Rotate-left of ``size``-bit values — reference utilities.h:96-103."""
    count = count % size
    mask = (1 << size) - 1
    bits = bits & mask
    return ((bits << count) & mask) | (bits >> (size - count))


def rotr(bits, count: int, size: int):
    """Rotate-right (tx-side inverse of :func:`rotl`)."""
    return rotl(bits, (size - count) % size, size)


def select_bits(data, indices):
    """Gather the bits listed in ``indices`` into a compact LSB-first value
    (reference utilities.h:209-216)."""
    out = data & 0
    for i, idx in enumerate(indices):
        out = out | (((data >> idx) & 1) << i)
    return out


def deshuffle(words):
    """Bit permutation: out bit j = in bit ``SHUFFLE_PATTERN[j]``
    (reference lib/decoder_impl.cc:611-637)."""
    out = words & 0
    for j, src in enumerate(SHUFFLE_PATTERN):
        out = out | (((words >> src) & 1) << j)
    return out


def shuffle(words):
    """Tx-side inverse of :func:`deshuffle`."""
    out = words & 0
    for j, dst in enumerate(SHUFFLE_PATTERN):
        out = out | (((words >> j) & 1) << dst)
    return out


def extract_data_only(codewords):
    """The 4 data bits {1,2,3,5} of each codeword byte (reference
    lib/decoder_impl.cc:693-706, uncoded CR 4/5-4/6 path)."""
    return select_bits(codewords, EXTRACT_DATA_INDICES)


def swap_nibbles(x):
    """Swap the two nibbles of each byte (reference utilities.h:274-278)."""
    return ((x & 0x0F) << 4) | ((x & 0xF0) >> 4)


def pack_nibbles_to_bytes(nibbles, high_first: bool):
    """Pairs of nibbles ``[..., 2n]`` -> bytes ``[..., n]`` (numpy).
    ``high_first``: ``(n[2i] << 4) | n[2i+1]`` (the header's order, as
    liquid-dsp's ``fec_decode`` packs); else ``(n[2i+1] << 4) | n[2i]``
    (the payload's, after the reference's ``swap_nibbles``). The count
    must be even."""
    n = nibbles.reshape(nibbles.shape[:-1] + (-1, 2))
    if high_first:
        return ((n[..., 0] << 4) | n[..., 1]).astype(nibbles.dtype)
    return ((n[..., 1] << 4) | n[..., 0]).astype(nibbles.dtype)


def unpack_bytes_to_nibbles(data, high_first: bool):
    """uint8 numpy ``[..., n]`` -> nibbles ``[..., 2n]`` (tx side)."""
    import numpy as np

    hi = (data & 0xF0) >> 4
    lo = data & 0x0F
    first, second = (hi, lo) if high_first else (lo, hi)
    return np.stack([first, second], axis=-1).reshape(data.shape[:-1] + (-1,))


def header_checksum_nibbles(length, cr, has_crc):
    """PHY header checksum ``(msn, lsn)`` over the 12 header bits (bit
    order per reference ``utilities.h:396-404``). Shared by the tx frame
    assembly and the rx checksum verification, on Python ints, numpy
    arrays or torch tensors."""
    n0 = (length >> 4) & 0x0F
    n1 = length & 0x0F
    n2 = ((cr & 0x7) << 1) | (has_crc & 0x1)

    def b(v, i):
        return (v >> i) & 1

    c4 = b(n0, 3) ^ b(n0, 2) ^ b(n0, 1) ^ b(n0, 0)
    c3 = b(n0, 3) ^ b(n1, 3) ^ b(n1, 2) ^ b(n1, 1) ^ b(n2, 0)
    c2 = b(n0, 2) ^ b(n1, 3) ^ b(n1, 0) ^ b(n2, 3) ^ b(n2, 1)
    c1 = b(n0, 1) ^ b(n1, 2) ^ b(n1, 0) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    c0 = b(n0, 0) ^ b(n1, 1) ^ b(n2, 3) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    return c4, (c3 << 3) | (c2 << 2) | (c1 << 1) | c0
