"""LoRa modulator: payload bytes -> IQ samples.

Inverse of the reference decode chain (lib/decoder_impl.cc:493-706), stage
by stage:

tx:  nibbles -> hamming84 encode -> whiten -> shuffle -> interleave
     -> gray-decode word to bin -> chirp shift
rx:  chirp demod -> gray encode -> deinterleave -> deshuffle -> dewhiten
     -> hamming decode

Frame layout on air (explicit header):

    [prlen x upchirp] [2 x sync upchirp] [2.25 x downchirp SFD]
    [8 header symbols @ SF-2] [N x payload symbols @ SF(-2 if reduced)]

The header block carries the 5 header codewords plus, for SF > 7, the
first ``sf-7`` payload codewords (the reference's deshuffle(is_header)
leaves them in ``d_demodulated`` — lib/decoder_impl.cc:631-633).
"""

from __future__ import annotations

import numpy as np

from ..config import LoRaConfig, MAC_CRC_SIZE
from ..ops import bits
from ..ops.chirp import build_ideal_chirps
from ..ops.hamming import hamming84_encode
from ..tables import PRNG_PAYLOAD_CR56, PRNG_PAYLOAD_CR78
from ..io.frames import header_checksum_nibbles, mac_crc


def payload_whitening(cr: int, n: int) -> np.ndarray:
    """First ``n`` payload whitening bytes for coding rate index ``cr``.

    Zero-padded past the table end (the reference would read out of bounds
    there — tables.h arrays are 516/518 bytes; an SF12 reduced-rate 255-byte
    frame needs up to 525).
    """
    table = PRNG_PAYLOAD_CR56 if cr <= 2 else PRNG_PAYLOAD_CR78
    out = np.zeros(n, dtype=np.uint8)
    m = min(n, len(table))
    out[:m] = np.asarray(table[:m], dtype=np.uint8)
    return out


def interleave_block(rows: np.ndarray, ppm: int, n_words: int) -> np.ndarray:
    """Inverse of the reference diagonal deinterleaver (:535-565).

    ``rows``: uint8 ``[..., ppm]`` codeword rows (each holding ``n_words``
    significant bits) -> uint16 ``[..., n_words]`` interleaved words of
    ``ppm`` bits, such that ``deint[x] bit i == bit x of rotl(word_i, i)``.
    """
    rows = rows.astype(np.uint16)
    words = np.zeros(rows.shape[:-1] + (n_words,), dtype=np.uint16)
    for i in range(n_words):
        w = np.zeros(rows.shape[:-1], dtype=np.uint16)
        for x in range(ppm):
            w |= ((rows[..., x] >> i) & 1).astype(np.uint16) << x
        words[..., i] = bits.rotr(w, i, ppm)
    return words


def deinterleave_block(words: np.ndarray, ppm: int) -> np.ndarray:
    """The reference's diagonal deinterleaver (:535-565), numpy: int
    ``[..., n_words]`` -> uint8 rows ``[..., ppm]`` with row x bit i = bit
    x of ``rotl(word_i, i, ppm)``."""
    n_words = words.shape[-1]
    rot = np.stack([bits.rotl(words[..., i], i, ppm) for i in range(n_words)], axis=-1)
    rows = np.zeros(words.shape[:-1] + (ppm,), dtype=np.uint8)
    for x in range(ppm):
        col = np.zeros(words.shape[:-1], dtype=np.uint16)
        for i in range(n_words):
            col |= ((rot[..., i] >> x) & 1).astype(np.uint16) << i
        rows[..., x] = col.astype(np.uint8)
    return rows


def encode_frame_symbols(config: LoRaConfig, payload: bytes) -> np.ndarray:
    """Payload bytes -> data symbol bins (int array).

    Returns the bin value sequence: 8 header-block bins in
    ``[0, 2^(sf-2))`` followed by payload bins (full or reduced range).
    ``payload`` excludes the MAC CRC; it is appended here when
    ``config.crc``.
    """
    sf, cr = config.sf, config.cr
    full = bytes(payload) + (mac_crc(bytes(payload)) if config.crc else b"")
    payload_length = len(full)
    if payload_length > 255 + MAC_CRC_SIZE:
        raise ValueError("payload too long")

    # --- nibbles -> whitened codewords ---
    pay_bytes = np.frombuffer(full, dtype=np.uint8)
    pay_nibbles = bits.unpack_bytes_to_nibbles(pay_bytes, high_first=False)
    # rx: fec_decode packs (cw0<<4)|cw1 then swap_nibbles => byte low nibble
    # comes from the first codeword: nibble order per byte is (lo, hi).
    pay_cw = hamming84_encode(pay_nibbles)

    if config.implicit:
        hdr_cw = np.zeros(0, dtype=np.uint8)
    else:
        if sf == 6:
            # Real LoRa requires implicit headers at SF6 (the 5 header
            # codewords don't fit the sf-2=4 rows of the first block; the
            # reference decoder would read past its buffers here).
            raise ValueError("SF6 requires implicit header mode")
        c_msn, c_lsn = header_checksum_nibbles(len(payload), cr, config.crc)
        hdr_nibbles = np.array(
            [
                (len(payload) >> 4) & 0xF,
                len(payload) & 0xF,
                ((cr & 0x7) << 1) | (1 if config.crc else 0),
                c_msn,
                c_lsn,
            ],
            dtype=np.uint8,
        )
        hdr_cw = hamming84_encode(hdr_nibbles)

    # --- block budget (reference :842-847) ---
    ppm_hdr = sf - 2
    ppm_pay = sf - 2 if config.reduced_rate else sf
    n_words_pay = 4 + cr
    hdr_slots = ppm_hdr - len(hdr_cw)  # payload codewords inside header block
    if config.implicit:
        needed = 2 * payload_length - hdr_slots
        n_blocks = max(0, -(-needed // ppm_pay))
    else:
        n_blocks = config.payload_symbol_count(payload_length) // n_words_pay
    total_pay_cw = hdr_slots + n_blocks * ppm_pay
    if total_pay_cw < len(pay_cw):
        raise ValueError("block budget too small for payload (internal error)")

    padded = np.zeros(total_pay_cw, dtype=np.uint8)
    padded[: len(pay_cw)] = pay_cw
    whitened = padded ^ payload_whitening(cr, total_pay_cw)

    # --- shuffle (inverse of deshuffle) ---
    hdr_rows = bits.shuffle(np.concatenate([hdr_cw, whitened[:hdr_slots]]))
    pay_rows = bits.shuffle(whitened[hdr_slots:]).reshape(n_blocks, ppm_pay)

    # --- interleave ---
    hdr_words = interleave_block(hdr_rows, ppm_hdr, 8)  # [8]
    pay_words = interleave_block(pay_rows, ppm_pay, n_words_pay).reshape(-1)

    # --- gray word -> bin ---
    hdr_bins = bits.gray_decode(hdr_words, ppm_hdr)
    pay_bins = bits.gray_decode(pay_words, ppm_pay)
    return np.concatenate([hdr_bins, pay_bins]).astype(np.int64), ppm_pay


class Modulator:
    """Synthesises IQ sample streams from payloads for a given config."""

    def __init__(self, config: LoRaConfig):
        self.config = config
        self.upchirp, self.downchirp = build_ideal_chirps(config)
        self.sps = config.samples_per_symbol
        self.decim = config.decim_factor
        self.n_bins = config.number_of_bins

    def _shifted_upchirp(self, shift_bins: int) -> np.ndarray:
        """Waveform for shift ``s``: ``u[(n + s*decim) % sps]``."""
        return np.roll(self.upchirp, -int(shift_bins) * self.decim)

    def symbols_to_iq(self, bins: np.ndarray, ppm_pay: int) -> np.ndarray:
        """Symbol bins -> full frame IQ (preamble ++ sync ++ SFD ++ data)."""
        cfg = self.config
        parts = []
        # preamble upchirps
        parts.extend([self.upchirp] * cfg.prlen)
        # two sync-word symbols: nibbles scaled by 8 (RN2483 convention);
        # sync 0x00 gives two plain upchirps.
        sync_hi, sync_lo = (cfg.sync_word >> 4) & 0xF, cfg.sync_word & 0xF
        for nib in (sync_hi, sync_lo):
            parts.append(self._shifted_upchirp((nib * 8) % self.n_bins))
        # SFD: 2.25 downchirps
        parts.extend([self.downchirp, self.downchirp, self.downchirp[: self.sps // 4]])
        # data symbols; the first block (8 symbols) is always reduced-rate
        for k, b in enumerate(bins):
            reduced = k < 8 or cfg.reduced_rate
            s = (4 * int(b) + 1) if reduced else (int(b) + 1) % self.n_bins
            parts.append(self._shifted_upchirp(s))
        iq = np.concatenate(parts).astype(np.complex64)
        return np.conj(iq) if cfg.conj else iq

    def frame_iq(self, payload: bytes) -> np.ndarray:
        bins, ppm_pay = encode_frame_symbols(self.config, payload)
        return self.symbols_to_iq(bins, ppm_pay)


def modulate_frame(
    config: LoRaConfig,
    payload: bytes,
    *,
    pad_before: int = 0,
    pad_after: int = 0,
    snr_db: float | None = None,
    cfo_hz: float = 0.0,
    amplitude: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """One padded frame with optional AWGN and carrier frequency offset.

    ``snr_db`` is relative to the chirp power (|1+1j|^2 * amplitude^2).
    """
    iq = Modulator(config).frame_iq(payload) * amplitude
    if cfo_hz:
        n = np.arange(len(iq))
        iq = iq * np.exp(2j * np.pi * cfo_hz * n / config.samp_rate).astype(np.complex64)
    stream = np.concatenate(
        [
            np.zeros(pad_before, dtype=np.complex64),
            iq.astype(np.complex64),
            np.zeros(pad_after, dtype=np.complex64),
        ]
    )
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        sig_pow = 2.0 * amplitude * amplitude
        noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
        noise = rng.normal(0, np.sqrt(noise_pow / 2), (len(stream), 2))
        stream = stream + (noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)
    return stream.astype(np.complex64)
