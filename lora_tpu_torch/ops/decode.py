"""Batched integer decode chain (gray words -> payload bytes).

Torch forms of the reference decode steps (lib/decoder_impl.cc:535-706),
batched over any leading axes (the receiver's decode lanes). Inputs and
outputs are int32 tensors; the lookup tables are host numpy arrays moved
to the input's device. The tables themselves are built in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bits
from .hamming import HAMMING84_DECODE_LUT
from ..tables import PRNG_PAYLOAD_CR56, PRNG_PAYLOAD_CR78

_HAM_LUT_I32 = HAMMING84_DECODE_LUT.astype(np.int32)


@functools.cache
def _ham_lut(device: torch.device) -> torch.Tensor:
    # moved once per device: a host-to-device copy blocks until the
    # stream drains, so none may sit on the per-block path
    return torch.as_tensor(_HAM_LUT_I32, device=device)


def payload_prng(n: int) -> tuple:
    """Zero-padded whitening tables ``(cr56, cr78)`` as int32[n] numpy."""
    t56 = np.zeros(n, np.int32)
    t78 = np.zeros(n, np.int32)
    m56 = min(n, len(PRNG_PAYLOAD_CR56))
    m78 = min(n, len(PRNG_PAYLOAD_CR78))
    t56[:m56] = PRNG_PAYLOAD_CR56[:m56]
    t78[:m78] = PRNG_PAYLOAD_CR78[:m78]
    return t56, t78


def deinterleave_words(words: torch.Tensor, n_valid, ppm: int) -> torch.Tensor:
    """Diagonal deinterleave of one block (reference :535-565).

    ``words``: int32 ``[..., n_words_max]``; entries at or past
    ``n_valid`` (an int, or an int tensor ``[...]``) are ignored. Returns
    rows int32 ``[..., ppm]`` where row x bit i = bit x of
    ``rotl(words[i], i, ppm)``.
    """
    dev = words.device
    n_words_max = words.shape[-1]
    rot = torch.stack(
        [bits.rotl(words[..., i], i, ppm) for i in range(n_words_max)], dim=-1)
    i_idx = torch.arange(n_words_max, dtype=torch.int32, device=dev)
    x_idx = torch.arange(ppm, dtype=torch.int32, device=dev)
    bits_mat = (rot[..., :, None] >> x_idx) & 1          # [..., n_words, ppm]
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid[..., None, None]
    in_block = i_idx[:, None] < n_valid
    contrib = torch.where(in_block, bits_mat << i_idx[:, None], 0)
    return contrib.sum(dim=-2, dtype=torch.int32)      # [..., ppm]


def decode_header(rows5: torch.Tensor) -> torch.Tensor:
    """5 header codeword rows -> 3 header bytes, int32 ``[..., 3]``
    (reference :826-852)."""
    deshuffled = bits.deshuffle(rows5)
    zeros = torch.zeros(rows5.shape[:-1] + (1,), dtype=torch.int32,
                        device=rows5.device)
    cw = torch.cat([deshuffled, zeros], dim=-1)   # 6 codewords, prng = 0
    nib = _ham_lut(rows5.device)[cw.long()]
    return torch.stack(
        [(nib[..., 0] << 4) | nib[..., 1],
         (nib[..., 2] << 4) | nib[..., 3],
         (nib[..., 4] << 4) | nib[..., 5]],
        dim=-1,
    ).to(torch.int32)


def parse_header(hdr_bytes: torch.Tensor):
    """loraphy bitfields + cr clamp (reference :833-838):
    ``(length, cr, has_mac_crc)`` int32."""
    length = hdr_bytes[..., 0]
    cr = torch.clamp((hdr_bytes[..., 1] >> 5) & 0x7, max=4)
    has_crc = (hdr_bytes[..., 1] >> 4) & 0x1
    return length, cr, has_crc


def header_checksum_valid(hdr_bytes: torch.Tensor) -> torch.Tensor:
    """Verify the PHY header checksum nibbles. On the wire the checksum
    LSN is byte 2's HIGH nibble (demo header ``04 90 40``: lsn 4 ->
    0x40). ``hdr_bytes`` int ``[..., 3]`` -> bool ``[...]``."""
    length = hdr_bytes[..., 0]
    b1 = hdr_bytes[..., 1]
    b2 = hdr_bytes[..., 2]
    crc_msn = b1 & 0x0F
    has = (b1 >> 4) & 0x1
    cr = (b1 >> 5) & 0x7
    crc_lsn = (b2 >> 4) & 0x0F
    c_msn, c_lsn = bits.header_checksum_nibbles(length, cr, has)
    return (crc_msn == c_msn) & (crc_lsn == c_lsn)


def payload_symbol_budget(length_with_crc: torch.Tensor, cr: torch.Tensor,
                          sf: int, reduced_rate: bool) -> torch.Tensor:
    """Reference :842-847 in float32, as the C++ float math does."""
    red = np.float32(2.0 if reduced_rate else 0.0)
    spb = (cr + 4).to(torch.float32)
    bits_needed = length_with_crc.to(torch.float32) * 8.0
    symbols_needed = bits_needed * (spb / 4.0) / float(np.float32(sf) - red)
    return (torch.ceil(symbols_needed / spb) * spb).to(torch.int32)


def decode_payload(codewords: torch.Tensor, n_valid: torch.Tensor,
                   cr: torch.Tensor) -> torch.Tensor:
    """The step-by-step payload decode (reference decode(false),
    :569-706) that :func:`decode_payload_lut` fuses: deshuffle, dewhiten,
    then Hamming (CR 4/7-4/8) or data-bit extraction (CR 4/5-4/6), on
    ``codewords``' device.

    ``codewords`` int32 ``[..., CW]``; ``n_valid``, ``cr`` int32 ``[...]``.
    Returns int32 ``[..., ceil(CW/2)]``; codewords at or past ``n_valid``
    decode as a zero byte would (bytes past the payload length are
    meaningless, as in the reference)."""
    dev = codewords.device
    CW = codewords.shape[-1]
    idx = torch.arange(CW, dtype=torch.int32, device=dev)
    deshuffled = bits.deshuffle(codewords) & 0xFF
    t56, t78 = (torch.as_tensor(t, device=dev) for t in payload_prng(CW))
    prng = torch.where((cr <= 2)[..., None], t56, t78)
    dewhitened = torch.where(idx < n_valid[..., None], deshuffled ^ prng, 0)
    if CW % 2:  # pad to an even codeword count for nibble pairing
        dewhitened = torch.nn.functional.pad(dewhitened, (0, 1))
    # CR 4/7-4/8: Hamming nibbles, (n0 << 4 | n1), then the nibble swap
    nib = _ham_lut(dev)[dewhitened.long()]
    b_ham = bits.swap_nibbles((nib[..., 0::2] << 4) | nib[..., 1::2])
    # CR 4/5-4/6: the data bits, packed (second << 4 | first)
    data = bits.extract_data_only(dewhitened)
    b_raw = (data[..., 1::2] << 4) | data[..., 0::2]
    crb = cr[..., None]
    return torch.where(crb >= 3, b_ham, torch.where(crb >= 1, b_raw, 0)).to(torch.int32)


def make_payload_nibble_lut(n_codewords: int) -> np.ndarray:
    """Fused deshuffle+dewhiten+FEC table for :func:`decode_payload_lut`.

    ``lut[v, k, c] = f_v(deshuffle(c) ^ prng_v[k])`` with ``v=0`` the
    CR 4/5-4/6 variant (prng_cr56 + data-bit extraction) and ``v=1`` the
    CR 4/7-4/8 variant (prng_cr78 + Hamming decode). int32
    ``[2, n_codewords, 256]``.
    """
    c = np.arange(256, dtype=np.int32)
    desh = bits.deshuffle(c)
    t56, t78 = payload_prng(n_codewords)
    lut = np.zeros((2, n_codewords, 256), np.int32)
    lut[0] = bits.extract_data_only(desh[None, :] ^ t56[:, None])
    lut[1] = _HAM_LUT_I32[desh[None, :] ^ t78[:, None]]
    return lut


def decode_payload_lut(codewords: torch.Tensor, n_valid: torch.Tensor,
                       cr: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Payload bytes from codewords through the fused table.

    ``codewords`` int32 ``[..., CW]``; ``n_valid``, ``cr`` int32 ``[...]``;
    ``lut`` = ``make_payload_nibble_lut(CW)`` on the same device. Returns
    int32 ``[..., ceil(CW/2)]``; codewords at or past ``n_valid`` decode
    as a zero byte would.
    """
    dev = codewords.device
    CW = codewords.shape[-1]
    idx = torch.arange(CW, dtype=torch.int32, device=dev)
    v = (cr >= 3).to(torch.int32)
    flat = v[..., None] * (CW * 256) + idx * 256 + (codewords & 0xFF)
    nib = lut.reshape(-1)[flat.long()]
    # extract(0) = 0; HLUT[0] is the Hamming nibble of a zero byte
    nib0 = torch.where(cr >= 3, int(_HAM_LUT_I32[0]), 0).to(torch.int32)
    nib = torch.where(idx < n_valid[..., None], nib, nib0[..., None])
    if CW % 2:  # pad to an even nibble count with the zero-byte nibble
        nib = torch.cat([nib, nib0[..., None]], dim=-1)
    # both variants pack as (odd << 4) | even
    b = (nib[..., 1::2] << 4) | nib[..., 0::2]
    return torch.where((cr >= 1)[..., None], b, 0).to(torch.int32)
