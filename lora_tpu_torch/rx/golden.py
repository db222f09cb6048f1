"""Golden sequential receiver: the numpy model of the reference state machine.

The port's own copy of the exactness-first model of ``decoder_impl::work``
(``lib/decoder_impl.cc:740-903``) and its helpers, kept deliberately
sequential and simple, in host numpy. It is the default engine of
:class:`lora_tpu_torch.receiver.LoRaReceiver`, and the yardstick the
batched receivers' decisions are read against. Its per-window DSP is the
numpy of :mod:`lora_tpu_torch.rx.golden_ops`, so its frames come from the
same float32 arithmetic as the reference model's.

State machine (reference lib/decoder_impl.h:40-48):

    DETECT -> SYNC -> FIND_SFD -> PAUSE -> DECODE_HEADER -> DECODE_PAYLOAD
    with FIND_SFD -> DETECT on 4+ correlation failures and
    DECODE_PAYLOAD -> DETECT after frame emission.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..config import LoRaConfig, MAC_CRC_SIZE, MAX_PWR_QUEUE_SIZE, payload_symbol_count
from ..io.frames import Frame, PhyHeader
from ..ops import bits
from ..ops.chirp import (build_ideal_chirps, instantaneous_frequency_np as
                         instantaneous_frequency, tiled_upchirp_ifreq)
from ..ops.hamming import hamming84_decode
from ..tables import PRNG_HEADER
from ..tx.modulator import deinterleave_block, payload_whitening
from . import golden_ops as demod


class DecoderState(enum.Enum):
    DETECT = 0
    SYNC = 1
    FIND_SFD = 2
    PAUSE = 3
    DECODE_HEADER = 4
    DECODE_PAYLOAD = 5
    STOP = 6


@dataclass
class DebugTrace:
    """Optional per-packet intermediates (reference GRLORA_DEBUG analogue)."""

    bins: List[int] = field(default_factory=list)
    words: List[int] = field(default_factory=list)
    fine_syncs: List[int] = field(default_factory=list)
    detect_corrs: List[float] = field(default_factory=list)
    sfd_corrs: List[float] = field(default_factory=list)
    # per-FIND_SFD-window tap: (pos, corr, bin, dist, decision) with
    # decision in {"sfd", "sync", "up", "fail"}
    sfd_walk: List[tuple] = field(default_factory=list)


class GoldenReceiver:
    def __init__(self, config: LoRaConfig, debug: bool = False):
        self.cfg = config
        self.debug = DebugTrace() if debug else None

        self.sps = config.samples_per_symbol
        self.decim = config.decim_factor
        self.n_bins = config.number_of_bins
        self.n_bins_hdr = config.number_of_bins_hdr

        up, down = build_ideal_chirps(config)
        self.upchirp, self.downchirp = up, down
        self.upchirp_ifreq = instantaneous_frequency(up)
        self.downchirp_ifreq = instantaneous_frequency(down)
        self.upchirp_ifreq_v = tiled_upchirp_ifreq(config)

        self._reset_all()

    # ---- lifecycle -------------------------------------------------------

    def _reset_all(self):
        cfg = self.cfg
        self.state = DecoderState.DETECT
        self.words: List[int] = []
        self.demodulated: List[int] = []
        self.decoded = np.zeros(0, dtype=np.uint8)
        self.payload_symbols = 0
        self.payload_length = 0
        self.energy_threshold = 0.0
        self.fine_sync = 0
        self.corr_fails = 0
        # Running mean of per-symbol fine-sync corrections during the
        # FIND_SFD walk — the sample-clock drift rate, fed forward across
        # the blind 2.25-symbol SFD consume (see PAUSE) and per data
        # symbol via the fractional accumulator (see DECODE_* states):
        # the predictable clock-offset slip is applied open-loop, so the
        # ±1-sample fine_sync feedback only carries the residual. This
        # extends tracking past the reference's ~1 sample/symbol ceiling
        # (SF12 @ 50 ppm slips 1.6 samples/symbol).
        self.drift_num = 0.0
        self.drift_den = 0
        self.drift_acc = 0.0
        # FIND_SFD sync-word recognition state (see run() FIND_SFD branch)
        self.sync_ref_bin = -1
        self.sync_run = 0
        self.sync_streak = 0
        self.snr = 0.0
        self.pwr_queue: List[float] = []
        # d_phdr initialised from constructor args (reference :72-73)
        self.phdr = PhyHeader(cr=cfg.cr, has_mac_crc=1 if cfg.crc else 0)

    # ---- reference helper mirrors ---------------------------------------

    def _drift_step(self) -> int:
        """Integer window advance owed to the open-loop drift rate this
        symbol (fractional remainder carries in ``drift_acc``)."""
        if self.cfg.disable_drift_correction:
            return 0
        self.drift_acc += self.drift_num / max(self.drift_den, 1)
        step = int(round(self.drift_acc))
        self.drift_acc -= step
        return step

    def _demodulate(self, window: np.ndarray, is_first: bool) -> bool:
        """reference demodulate() :493-529."""
        cfg = self.cfg
        reduced = is_first or cfg.reduced_rate
        bin_idx = int(demod.max_frequency_gradient_idx(window, self.n_bins, self.decim))
        if not cfg.disable_drift_correction:
            self.fine_sync = int(
                demod.fine_sync_lag(
                    window, np.int64(bin_idx), self.upchirp_ifreq_v,
                    self.sps, self.decim,
                    demod.fine_sync_search_space(self.decim),
                )
            )
        if reduced:
            bin_idx = int(np.floor(bin_idx / 4.0 + 0.5)) % self.n_bins_hdr
        word = bin_idx ^ (bin_idx >> 1)
        if self.debug is not None:
            self.debug.bins.append(bin_idx)
            self.debug.words.append(word)
            self.debug.fine_syncs.append(self.fine_sync)
        self.words.append(word)
        if len(self.words) == 4 + (4 if is_first else cfg.cr):
            ppm = cfg.sf - 2 if reduced else cfg.sf
            rows = deinterleave_block(np.asarray(self.words, dtype=np.uint16), ppm)
            self.demodulated.extend(int(r) for r in rows)
            self.words.clear()
            return True
        return False

    def _decode(self, is_header: bool) -> np.ndarray:
        """reference decode() :567-586 + hamming_decode :654-675."""
        cfg = self.cfg
        dem = np.asarray(self.demodulated, dtype=np.uint8)
        if is_header:
            to_decode = bits.deshuffle(dem[:5])
            self.demodulated = self.demodulated[5:]
            deshuffled = np.concatenate([to_decode, np.zeros(1, dtype=np.uint8)])
            prng = np.asarray(PRNG_HEADER[: len(deshuffled)], dtype=np.uint8)
        else:
            deshuffled = bits.deshuffle(dem)
            self.demodulated = []
            prng = payload_whitening(self.phdr.cr, len(deshuffled))
        dewhitened = deshuffled ^ prng

        cr = self.phdr.cr
        if cr in (4, 3):
            # liquid fec_decode(HAMMING84, n) consumes 2n codewords; for CR3
            # that overruns the input in the reference (bytes past
            # payload_length are garbage there, zeros here — both ignored).
            n = int(np.ceil(len(dewhitened) * 4.0 / (4.0 + cr)))
            nibbles = hamming84_decode(dewhitened)
            if len(nibbles) < 2 * n:
                nibbles = np.concatenate(
                    [nibbles, np.zeros(2 * n - len(nibbles), dtype=np.uint8)]
                )
            decoded = bits.pack_nibbles_to_bytes(nibbles[: 2 * n], high_first=True)
            if not is_header:
                decoded = bits.swap_nibbles(decoded)
        elif cr in (2, 1):  # no FEC, extract data bits (reference :693-706)
            data = bits.extract_data_only(dewhitened)
            if len(data) % 2:
                data = np.concatenate([data, np.zeros(1, dtype=np.uint8)])
            decoded = bits.pack_nibbles_to_bytes(data, high_first=is_header)
        else:  # cr == 0: reference switch has no matching case; stays empty
            decoded = np.zeros(0, dtype=np.uint8)
        self.decoded = decoded.astype(np.uint8)
        return self.decoded

    # ---- the state machine ----------------------------------------------

    def run(self, samples: np.ndarray, step_callback=None) -> List[Frame]:
        """Feed a complex64 stream; returns decoded frames.

        ``step_callback(state, position)``, when given, is invoked before
        every state-machine step (debug/observability hook, the analogue of
        the reference's DBGR_CHRONO instrumentation points).
        """
        cfg = self.cfg
        samples = np.asarray(samples, dtype=np.complex64)
        if cfg.conj:
            samples = np.conj(samples)
        frames: List[Frame] = []
        sps = self.sps
        p = 0
        n = len(samples)

        while p + 2 * sps <= n:
            if step_callback is not None:
                step_callback(self.state, p)
            self.fine_sync = 0
            window = samples[p : p + 2 * sps]

            if self.state is DecoderState.DETECT:
                corr, e1, e2 = demod.preamble_autocorr(window, sps)
                self.energy_threshold = float(e2) / 2.0
                self.pwr_queue.append(float(e1) / sps)
                if len(self.pwr_queue) > MAX_PWR_QUEUE_SIZE:
                    self.pwr_queue.pop(0)
                if self.debug is not None:
                    self.debug.detect_corrs.append(float(corr))
                if corr >= 0.90:
                    if len(self.pwr_queue) >= 2:
                        # C++ float semantics: x/0 = inf, not an exception
                        self.snr = (
                            self.pwr_queue[-1] / self.pwr_queue[0]
                            if self.pwr_queue[0] != 0.0 else float("inf")
                        )
                    self.corr_fails = 0
                    self.drift_num = 0.0
                    self.drift_den = 0
                    self.drift_acc = 0.0
                    self.sync_ref_bin = -1
                    self.sync_run = 0
                    self.sync_streak = 0
                    self.state = DecoderState.SYNC
                    # Sync one window past the detection edge (same rule
                    # as the dense engine, rx/dense.py process_complex):
                    # the edge window may start before the preamble, and
                    # leading silence/filter transient skews the sliding
                    # sync xcorr by hundreds of samples at SF>=11 — a
                    # misalignment the filtered ifreq Pearson then sits in
                    # the dead zone for (c ~ -0.968 > -0.97), never
                    # resyncing. One window later is fully inside the
                    # >=8-symbol preamble; the SFD walk budget absorbs the
                    # extra symbol. The reference instead relies on
                    # walk-abort/re-detect cycles, which starve when the
                    # remaining preamble is the two differently-shifted
                    # sync symbols (low autocorr).
                    p += sps
                else:
                    p += sps

            elif self.state is DecoderState.SYNC:
                i, _ = demod.upchirp_sync_xcorr(window, self.upchirp_ifreq, sps)
                p += int(i)
                self.state = DecoderState.FIND_SFD

            elif self.state is DecoderState.FIND_SFD:
                c = float(demod.downchirp_pearson(window[:sps], self.downchirp_ifreq, sps))
                if self.debug is not None:
                    self.debug.sfd_corrs.append(c)
                if c > 0.96:
                    self.state = DecoderState.PAUSE
                else:
                    # Sync-word recognition (beyond the reference): the two
                    # sync symbols are upchirps shifted by sync-nibble*8
                    # bins. At SF>=11 the shift disturbs so little of the
                    # symbol that the downchirp correlation stays < -0.97
                    # and the reference's still-upchirp resync branch
                    # (lib/decoder_impl.cc:801-803) fine-syncs against the
                    # UNSHIFTED upchirp, dragging alignment by up to
                    # 4*decim-1 samples — corrupting every payload bin.
                    # A run of <= 2 upchirps clearly shifted relative to
                    # the stable preamble bin is the sync word: hold
                    # alignment and spend no correlation-fail budget.
                    # The relative distance is CFO-proof (CFO shifts every
                    # bin equally). A MISALIGNED plain upchirp also reads
                    # a shifted bin, so recognition additionally requires
                    # >= 2 consecutive stable preamble reads
                    # (``sync_streak``) — a wandering walk (e.g. the
                    # channel filter's edge transient skewing SYNC) keeps
                    # resyncing instead, re-anchoring the reference bin
                    # each time. Plain-preamble traces (sync 0x00) read
                    # dist 0 throughout and are unaffected.
                    b = int(demod.max_frequency_gradient_idx(
                        window[:sps], self.n_bins, self.decim))
                    if self.sync_ref_bin < 0:
                        self.sync_ref_bin = b
                        self.sync_streak = 1
                    rel = (b - self.sync_ref_bin) % self.n_bins
                    dist = min(rel, self.n_bins - rel)
                    # NOTE sync_run is a TOTAL per-walk budget, not a
                    # resettable run: a constantly-misaligned periodic
                    # preamble reads a consistent shifted bin too, and a
                    # resettable budget would recognise it indefinitely,
                    # starving the corr_fails -> DETECT retry that rescues
                    # badly-synced candidates (seen with the channel
                    # filter's edge transient skewing SYNC on implicit
                    # traces). Capped at 2 the walk loses at most 2
                    # windows to misrecognition.
                    likeness = float(demod.upchirp_likeness(
                        window[:sps], np.int64(b), self.upchirp_ifreq_v,
                        sps, self.decim))
                    recognised = (dist > 3 and self.sync_run < 2
                                  and self.sync_streak >= 2
                                  and likeness > demod.SYNC_LIKENESS_MIN)
                    if recognised:
                        self.sync_run += 1
                    elif c < -0.97:
                        if dist <= 3:
                            self.sync_streak += 1
                        else:  # re-anchor: walk not aligned to ref yet
                            self.sync_ref_bin = b
                            self.sync_streak = 1
                        self.fine_sync = int(
                            demod.fine_sync_lag(
                                window[:sps], np.int64(-1), self.upchirp_ifreq_v,
                                sps, self.decim, self.decim * 4,
                            )
                        )
                        # sample-clock drift estimate from the per-upchirp
                        # corrections (large lags are resyncs, not drift)
                        if abs(self.fine_sync) <= self.decim // 2:
                            self.drift_num += self.fine_sync
                            self.drift_den += 1
                    else:
                        self.corr_fails += 1
                    if self.debug is not None:
                        dec = ("sync" if recognised
                               else "up" if c < -0.97 else "fail")
                        self.debug.sfd_walk.append((p, c, b, dist, dec))
                    if self.corr_fails > 4:
                        self.state = DecoderState.DETECT
                # DELIBERATE golden-vs-dense divergence: the reference
                # consumes sps + d_fine_sync on EVERY FIND_SFD window with
                # d_fine_sync persisting from the last upchirp
                # (lib/decoder_impl.cc:816,300-338) — so recognised
                # sync-word and fail windows advance with the stale
                # correction here, while the dense engine advances
                # those windows with fine=0. The divergence is at most
                # decim/2 per non-upchirp window (inside every alignment
                # tolerance); golden keeps the reference semantics because
                # its job is the 1:1 state-machine mirror.
                p += sps + self.fine_sync

            elif self.state is DecoderState.PAUSE:
                self.state = DecoderState.DECODE_HEADER
                # Feed the measured drift rate forward across the blind
                # 2.25-symbol SFD region (this consume + the FIND_SFD found
                # branch): at SF12 / 30 ppm the symbol grid slips ~1 sample
                # per symbol, and handing the first header symbol over >3
                # samples late puts the demod's tail glitch past the trim
                # (see ops/demod.max_frequency_gradient_idx). The reference
                # consumes blind here (lib/decoder_impl.cc:820-822) and
                # loses SF11/12 at crystal-tolerance drift.
                rate = self.drift_num / max(self.drift_den, 1)
                p += sps + cfg.delay_after_sync + round(2.25 * rate)

            elif self.state is DecoderState.DECODE_HEADER:
                if self._demodulate(window[:sps], True):
                    if cfg.implicit:
                        self.payload_symbols = 1
                    else:
                        decoded = self._decode(True)
                        if len(decoded) < 3:
                            # A prior garbage header can leave phdr.cr == 0,
                            # whose decode branch yields no bytes; the
                            # reference then memcpy's 3 bytes from an empty
                            # vector (decoder_impl.cc:826, undefined reads).
                            # Refuse to mirror the UB: drop sync, back to
                            # DETECT (garbage headers can't produce a valid
                            # frame either way). Surfaced by the *drift*
                            # suites' occasional mis-synced candidates.
                            self._reset_all()
                            p += sps
                            continue
                        self.phdr = PhyHeader.from_bytes(bytes(decoded[:3]))
                        if self.phdr.cr > 4:
                            self.phdr.cr = 4  # reference :834-835
                        self.decoded = np.zeros(0, dtype=np.uint8)
                        self.payload_length = (
                            self.phdr.length + MAC_CRC_SIZE * self.phdr.has_mac_crc
                        )
                        self.payload_symbols = payload_symbol_count(
                            cfg.sf, self.phdr.cr, cfg.reduced_rate, self.payload_length
                        )
                    self.state = DecoderState.DECODE_PAYLOAD
                p += sps + self.fine_sync + self._drift_step()

            elif self.state is DecoderState.DECODE_PAYLOAD:
                if cfg.implicit and float(demod.symbol_energy(window[:sps])) < self.energy_threshold:
                    self.payload_symbols = 0
                    self.payload_length = len(self.demodulated) // 2
                elif self._demodulate(window[:sps], False):
                    if not cfg.implicit:
                        self.payload_symbols -= 4 + self.phdr.cr
                if self.payload_symbols <= 0:
                    decoded = self._decode(False)
                    frames.append(
                        Frame(
                            phy_header=PhyHeader(**vars(self.phdr)),
                            payload=bytes(decoded[: self.payload_length]),
                            snr=self.snr,
                            sample_index=p,
                        )
                    )
                    self.state = DecoderState.DETECT
                    self.decoded = np.zeros(0, dtype=np.uint8)
                    self.words.clear()
                    self.demodulated = []
                p += sps + self.fine_sync + self._drift_step()

            else:  # STOP
                p += sps

        return frames
