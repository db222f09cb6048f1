"""Independent second modulator — tx/rx de-correlation evidence.

The port's own copy of ``lora_tpu.tx.altmod`` (numpy): the same
samples for the same arguments.

Every accuracy number in this framework is a self-round-trip: our
modulator -> our receiver. The integer half of that loop is pinned to
the reference by the compiled oracle (tests/test_oracle.py), but the
*analog* half (chirp synthesis, symbol timing, sync conventions) could
hide a correlated tx/rx bug — e.g. a shared chirp-sign error — that no
round-trip can see. This module is the control experiment: a complete
second modulator written against the LoRa PHY description with NO code
shared with ``tx/modulator.py``, ``ops/chirp.py``, ``ops/bits.py`` or
``ops/hamming.py``. If both transmitters cross-decode at 100%, the
receiver's conventions are pinned by two independent implementations.

Independence inventory:

- **Chirp synthesis**: phase-accumulator integration of the PHY
  frequency trajectory (f ramps bw/T_sym per second, wrapping at
  +bw/2), NOT the closed-form quadratic phase of ``ops/chirp``.
- **Hamming(8,4)**: parity equations per the documented encoder
  (reference ``include/lora/utilities.h:257-264``), not the LUTs of
  ``ops/hamming``.
- **Gray / shuffle / interleave / header / CRC**: independent loops
  from the documented chain (reference ``lib/decoder_impl.cc:493-706``
  read as a spec of the *inverse* direction).
- **Impairments**: CFO by its own phase accumulator; clock drift by
  linear-interpolation resampling (vs the MMSE polyphase bank);
  AWGN from an independently-seeded Generator.

Shared with the primary modulator — deliberately:

- ``LoRaConfig`` (parameter plumbing, no signal math).
- The whitening byte sequences (``tables.py``): reverse-engineered
  protocol DATA, verified byte-exact against the reference's
  ``lib/tables.h`` by the oracle tests. Data cannot carry a correlated
  *algorithmic* bug, and re-deriving it is impossible by construction
  (it was captured over the air).

Symbol-shift convention, derived here rather than inherited: the
reference's gradient demod (lib/decoder_impl.cc:466-491) scans the
bin-averaged instantaneous frequency, stores ``i+1`` for the largest
negative gradient between bins ``i`` and ``i+1``, and returns
``(N - max_index) % N``. A data chirp cyclically advanced by ``s`` bins
wraps at bin ``N - s``, i.e. between averaged bins ``N-s-1`` and
``N-s`` -> stored index ``N-s`` -> demodulated value ``s``... for the
wrap *gradient* to register at index ``i = N-s-1`` the stored value is
``i+1 = N-s`` and the result is ``s``. The receiver chain's gray stage
expects ``bin = value - 1``? No: cross-examining the FFT demod
(:430-464), a shift of ``s`` bins lands the dechirped tone in FFT bin
``s`` while the gradient method reads ``s - 1`` for the same waveform
(the two methods' published bin conventions differ by one; README
conformance notes). The decode chain is built on the gradient
convention, so transmitting payload value ``b`` requires the cyclic
shift ``s = b + 1 (mod N)`` (reduced-rate: ``4*b + 1``) — the same
conclusion the primary modulator reached, here re-derived from the
demod's documented arithmetic.
"""

from __future__ import annotations

import numpy as np

from ..config import LoRaConfig, MAC_CRC_SIZE
from ..tables import PRNG_HEADER, PRNG_PAYLOAD_CR56, PRNG_PAYLOAD_CR78

# rx deshuffle writes output bit i from input bit PATTERN[i]
# (lib/decoder_impl.cc:568,611-637); protocol constant
_DESHUFFLE = (5, 0, 1, 2, 4, 3, 6, 7)


# ---------------------------------------------------------------- bits
def _hamming84(nibble: int) -> int:
    """Hamming(7,4)+parity encoder from the documented parity equations
    (utilities.h:257-264): codeword bits (LSB first) are
    ``p1 d0 d1 d2 p2 d3 p3 p4``."""
    d = [(nibble >> i) & 1 for i in range(4)]
    p1 = d[1] ^ d[2] ^ d[3]
    p2 = d[0] ^ d[1] ^ d[2]
    p3 = d[0] ^ d[1] ^ d[3]
    p4 = d[0] ^ d[2] ^ d[3]
    seq = (p1, d[0], d[1], d[2], p2, d[3], p3, p4)
    return sum(b << i for i, b in enumerate(seq))


def _shuffle(cw: int) -> int:
    """Inverse of the rx deshuffle: place decoded bit i at raw position
    ``_DESHUFFLE[i]`` so the receiver's gather restores order."""
    out = 0
    for i, src in enumerate(_DESHUFFLE):
        out |= ((cw >> i) & 1) << src
    return out


def _gray_to_bin(word: int, nbits: int) -> int:
    """Invert the rx gray stage ``word = bin ^ (bin >> 1)``."""
    b = word
    shift = 1
    while shift < nbits:
        b ^= b >> shift
        shift <<= 1
    return b & ((1 << nbits) - 1)


def _interleave(rows: np.ndarray, ppm: int, n_words: int) -> np.ndarray:
    """Diagonal interleaver, derived by inverting the documented rx
    deinterleave (lib/decoder_impl.cc:535-565): codeword ``k`` bit ``i``
    equals word ``i`` bit ``(k - i) mod ppm`` within a block — so word
    ``i`` bit ``q`` feeds codeword ``(q + i) mod ppm`` at bit ``i``."""
    assert len(rows) == ppm
    words = np.zeros(n_words, dtype=np.int64)
    # cw k, bit i <- word i, bit (k - i) mod ppm  =>  word i, bit q
    # feeds cw (q + i) mod ppm at bit i
    for i in range(n_words):
        w = 0
        for q in range(ppm):
            k = (q + i) % ppm
            w |= ((int(rows[k]) >> i) & 1) << q
        words[i] = w
    return words


def _whitening(cr: int, n: int) -> np.ndarray:
    table = np.asarray(
        PRNG_PAYLOAD_CR56 if cr <= 2 else PRNG_PAYLOAD_CR78, dtype=np.uint8
    )
    out = np.zeros(n, dtype=np.uint8)
    m = min(n, len(table))
    out[:m] = table[:m]
    return out


def _crc16(data: bytes) -> bytes:
    """Payload CRC-16 (CCITT 0x1021, init 0) XORed with the last two
    payload bytes, little-endian on the wire."""
    reg = 0
    for byte in data[:-2] if len(data) > 2 else b"":
        reg ^= byte << 8
        for _ in range(8):
            reg = ((reg << 1) ^ 0x1021) & 0xFFFF if reg & 0x8000 \
                else (reg << 1) & 0xFFFF
    if len(data) >= 2:
        reg ^= data[-1] ^ (data[-2] << 8)
    elif len(data) == 1:
        reg ^= data[-1]
    return bytes((reg & 0xFF, reg >> 8))


def _header_nibbles(length: int, cr: int, has_crc: bool):
    """PHY header nibbles incl. the 5-bit checksum (bit equations per
    the ordering documented at utilities.h:396-404)."""
    n0 = (length >> 4) & 0xF
    n1 = length & 0xF
    n2 = ((cr & 0x7) << 1) | (1 if has_crc else 0)
    b = lambda v, i: (v >> i) & 1  # noqa: E731
    c4 = b(n0, 3) ^ b(n0, 2) ^ b(n0, 1) ^ b(n0, 0)
    c3 = b(n0, 3) ^ b(n1, 3) ^ b(n1, 2) ^ b(n1, 1) ^ b(n2, 0)
    c2 = b(n0, 2) ^ b(n1, 3) ^ b(n1, 0) ^ b(n2, 3) ^ b(n2, 1)
    c1 = b(n0, 1) ^ b(n1, 2) ^ b(n1, 0) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    c0 = b(n0, 0) ^ b(n1, 1) ^ b(n2, 3) ^ b(n2, 2) ^ b(n2, 1) ^ b(n2, 0)
    return [n0, n1, n2, c4, (c3 << 3) | (c2 << 2) | (c1 << 1) | c0]


# ------------------------------------------------------------- symbols
def encode_symbols(cfg: LoRaConfig, payload: bytes) -> np.ndarray:
    """Payload bytes -> demodulated-bin sequence (8 header-block bins
    then payload bins), independently of tx/modulator.py."""
    sf, cr = cfg.sf, cfg.cr
    wire = bytes(payload) + (_crc16(bytes(payload)) if cfg.crc else b"")

    # nibbles, low nibble of each byte first (the rx packs (cw0<<4)|cw1
    # then swap_nibbles, so the first codeword is the LOW nibble)
    nibbles = []
    for byte in wire:
        nibbles.append(byte & 0xF)
        nibbles.append(byte >> 4)
    pay_cw = [_hamming84(n) for n in nibbles]

    ppm_hdr = sf - 2
    ppm_pay = sf - 2 if cfg.reduced_rate else sf
    blk = 4 + cr
    if cfg.implicit:
        hdr_cw = []
    else:
        if sf == 6:
            raise ValueError("SF6 requires implicit header mode")
        hdr_cw = [_hamming84(n) for n in
                  _header_nibbles(len(payload), cr, cfg.crc)]
    hdr_slots = ppm_hdr - len(hdr_cw)

    # block budget (reference :842-847): symbols for 8*len bits at
    # (4+cr)/4 code rate over (sf - 2*reduced) bits/symbol
    red = 2.0 if cfg.reduced_rate else 0.0
    if cfg.implicit:
        need = 2 * len(wire) - hdr_slots
        n_blocks = max(0, -(-need // ppm_pay))
    else:
        sym_needed = (len(wire) * 8.0) * (blk / 4.0) / (sf - red)
        n_blocks = int(np.ceil(np.float32(sym_needed) / blk))
    total_cw = hdr_slots + n_blocks * ppm_pay

    padded = np.zeros(total_cw, dtype=np.uint8)
    padded[: len(pay_cw)] = pay_cw[:total_cw]
    white = padded ^ _whitening(cr, total_cw)

    shuffled = np.array([_shuffle(int(c)) for c in white], dtype=np.int64)
    hdr_rows = np.array(
        [_shuffle(c) for c in hdr_cw] + list(shuffled[:hdr_slots]),
        dtype=np.int64,
    )
    bins = []
    hdr_words = _interleave(hdr_rows, ppm_hdr, 8)
    bins.extend(_gray_to_bin(int(w), ppm_hdr) for w in hdr_words)
    for nblk in range(n_blocks):
        rows = shuffled[hdr_slots + nblk * ppm_pay:
                        hdr_slots + (nblk + 1) * ppm_pay]
        for w in _interleave(rows, ppm_pay, blk):
            bins.append(_gray_to_bin(int(w), ppm_pay))
    return np.asarray(bins, dtype=np.int64)


# -------------------------------------------------------------- analog
def _chirp_iq(cfg: LoRaConfig, shift_bins: int, n_samples: int = None,
              down: bool = False) -> np.ndarray:
    """Phase-accumulator chirp: integrate the PHY frequency trajectory.

    An upchirp's instantaneous frequency ramps linearly from -bw/2 to
    +bw/2 over one symbol; a cyclic shift of ``s`` bins starts the ramp
    at ``-bw/2 + s*bw/N`` and wraps to ``-bw/2`` when it reaches
    ``+bw/2``. A downchirp negates the trajectory. Phase is the running
    sum of ``2*pi*f/fs`` — no closed-form quadratic phase shared with
    ``ops/chirp``.
    """
    sps = cfg.samples_per_symbol
    N = cfg.number_of_bins
    bw = cfg.bandwidth
    fs = cfg.samp_rate
    n = sps if n_samples is None else n_samples
    k = np.arange(n, dtype=np.float64)
    f = -bw / 2.0 + ((shift_bins * bw / N + k * bw * bw /
                      (N * fs)) % bw)
    if down:
        f = -f
    # accumulate phase; start each symbol at phase 0 (the receiver's
    # ifreq demod reads phase DIFFS, so the per-symbol phase origin is
    # immaterial; symbol-boundary continuity is not required by the PHY)
    phase = 2.0 * np.pi * np.cumsum(f) / fs
    phase = np.concatenate([[0.0], phase[:-1]])
    return np.exp(1j * phase).astype(np.complex64)


def frame_iq(cfg: LoRaConfig, payload: bytes) -> np.ndarray:
    """Full frame: preamble ++ sync word ++ 2.25-symbol SFD ++ data."""
    sps = cfg.samples_per_symbol
    N = cfg.number_of_bins
    parts = [_chirp_iq(cfg, 0)] * cfg.prlen
    for nib in ((cfg.sync_word >> 4) & 0xF, cfg.sync_word & 0xF):
        parts.append(_chirp_iq(cfg, (nib * 8) % N))
    parts.append(_chirp_iq(cfg, 0, down=True))
    parts.append(_chirp_iq(cfg, 0, down=True))
    parts.append(_chirp_iq(cfg, 0, n_samples=sps // 4, down=True))
    bins = encode_symbols(cfg, payload)
    for k, b in enumerate(bins):
        reduced = k < 8 or cfg.reduced_rate
        s = (4 * int(b) + 1) if reduced else (int(b) + 1) % N
        parts.append(_chirp_iq(cfg, s % N))
    iq = np.concatenate(parts)
    return np.conj(iq) if cfg.conj else iq


def modulate_frame_alt(
    cfg: LoRaConfig,
    payload: bytes,
    *,
    pad_before: int = 0,
    pad_after: int = 0,
    snr_db: float | None = None,
    cfo_hz: float = 0.0,
    drift_ppm: float = 0.0,
    amplitude: float = 1.0,
    seed: int = 12345,
) -> np.ndarray:
    """One impaired frame — same contract as ``modulate_frame`` but with
    independent impairment implementations (own CFO phase accumulator,
    linear-interpolation clock drift, independently-ordered AWGN)."""
    iq = frame_iq(cfg, payload) * amplitude
    if drift_ppm:
        # sample-clock offset: resample by 1 + ppm*1e-6 with linear
        # interpolation (vs the primary path's MMSE polyphase bank)
        ratio = 1.0 + drift_ppm * 1e-6
        pos = np.arange(int((len(iq) - 1) / ratio)) * ratio
        i0 = np.floor(pos).astype(np.int64)
        frac = (pos - i0).astype(np.float64)
        iq = ((1.0 - frac) * iq[i0] + frac * iq[i0 + 1]).astype(np.complex64)
    if cfo_hz:
        dphi = 2.0 * np.pi * cfo_hz / cfg.samp_rate
        rot = np.exp(1j * dphi * np.arange(len(iq)))
        iq = (iq * rot).astype(np.complex64)
    out = np.concatenate([
        np.zeros(pad_before, np.complex64),
        iq.astype(np.complex64),
        np.zeros(pad_after, np.complex64),
    ])
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        sig = 2.0 * amplitude * amplitude
        npow = sig / (10.0 ** (snr_db / 10.0))
        # complex noise drawn as one complex-normal stream (the primary
        # modulator draws an (n, 2) real block — different stream order)
        noise = (rng.standard_normal(len(out))
                 + 1j * rng.standard_normal(len(out)))
        out = out + (noise * np.sqrt(npow / 2.0)).astype(np.complex64)
    return out.astype(np.complex64)
