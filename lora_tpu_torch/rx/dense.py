"""Dense two-phase receiver.

Phase A computes the preamble metric of every symbol-stride window of a
block in one pass (the hand-written detection kernel on the card, its
plain torch version on the CPU) and picks rising-edge candidates at a
fixed capacity per channel. Phase B decodes every candidate lane at once:
each sub-window a lane reads (sync, SFD search, header + payload symbols)
is one batched gather from the source planes, and the fold-DFT matmuls,
Pearson correlations and the integer decode tail run batched over the
lanes. No ``pkt_samples`` region is materialised per lane.

Demod engines (``demod_method``):

- ``gradient``: the reference's ifreq-gradient demod with its per-symbol
  fine-sync drift tracking (lib/decoder_impl.cc:466-491,300-338), after a
  CFO-invariant upchirp sync (``fast_sync``; ``False`` selects the
  reference's sliding search) and the reference's SFD walk. JAX's two
  ``lax.scan`` loops are Python loops over symbols here, every lane of a
  step batched.
- ``fft``: dechirp + fold-DFT matmul argmax on a static window grid, with
  the fold-DFT matrices where they fit (``sps * n_bins <= 16M``) and the
  dechirp FFT where they do not (SF12 at 250 ksps); the fft drift pass
  (auto-on from SF11).
- ``auto`` (default): ``gradient`` at decimation >= 4 with explicit
  headers, ``fft`` otherwise, as JAX resolves it.

Header-checksum verification (``header_checksum``) is ported, as in JAX.
Not ported yet, and refused with ``NotImplementedError``: implicit
headers, ``low_snr`` and ``debug_trace``.

:meth:`DenseReceiver.process_pooled_planes` is the many-channel form: the
strongest candidates of all channels share one global pool of lanes. It
takes precomputed detection metrics, which the multi-SF gateway derives
for every SF from one shared pass over the channel planes; with them it
reads the planes where they lie, the channelizer's pitched view
included.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import LoRaConfig, MAC_CRC_SIZE
from ..device import full_f32_matmul, resolve_device
from ..io.frames import Frame, PhyHeader
from ..ops import decode as dec, demod
from ..ops.chirp import (build_ideal_chirps, instantaneous_frequency_np,
                         tiled_upchirp_ifreq)
from ..ops.cuda_kernels import detection_metrics_kernel
from ..ops.xfer import pack_iq
from .frontend import candidate_starts, leak_suppression

MAX_PAYLOAD = 260
FOLD_BUDGET = 16 * 1024 * 1024  # fold-DFT entries (sps * n_bins)


class PooledResult(NamedTuple):
    """Global-candidate-pool result: flat ``[G]`` lanes with their channel.

    For many-channel blocks Phase B capacity scales with the aggregate
    packet load, not ``channels x per-channel capacity``: candidates from
    all channels are compacted into one pool of ``G`` decode lanes."""

    valid: torch.Tensor       # bool[G]
    channel: torch.Tensor     # int32[G] source channel of each lane
    payload: torch.Tensor     # uint8[G, MAX_PAYLOAD]
    length: torch.Tensor      # int32[G]
    hdr: torch.Tensor         # uint8[G, 3]
    snr: torch.Tensor         # f32[G]
    start: torch.Tensor       # int32[G] start sample within the channel
    cfo: torch.Tensor         # f32[G]
    n_dropped: torch.Tensor   # int32[] candidates past per-channel or pool capacity


class DenseResult(NamedTuple):
    """Struct-of-arrays decode result for a block: ``[..., P]`` leading dims."""

    valid: torch.Tensor       # bool[..., P] frame decoded
    payload: torch.Tensor     # uint8[..., P, MAX_PAYLOAD]
    length: torch.Tensor      # int32[..., P] payload bytes incl. CRC
    hdr: torch.Tensor         # uint8[..., P, 3] phy header bytes
    snr: torch.Tensor         # f32[..., P]
    start: torch.Tensor       # int32[..., P] packet start sample in block
    cfo: torch.Tensor         # f32[..., P] carrier frequency offset (Hz)
    n_dropped: torch.Tensor   # int32[...] rising-edge candidates past capacity


def codeword_capacity(config: LoRaConfig, max_symbols: int) -> int:
    """Payload codewords a lane can carry: the header block's spare rows
    plus every full CR 4/5 block of ``max_symbols``."""
    ppm = config.sf - 2 if config.reduced_rate else config.sf
    return config.sf - 2 - 5 + (max_symbols // 5) * ppm


def build_deint_tables(config: LoRaConfig, max_symbols: int):
    """Gather tables of the per-CR diagonal deinterleave (reference
    :535-565): codeword ``k`` of variant ``cr`` has bit ``i`` = bit
    ``(x - i) mod ppm`` of payload word ``n*(4+cr) + i`` with
    ``n = k // ppm``, ``x = k % ppm``. ``(src, shift, mask)`` int32
    ``[4, CW, 8]``."""
    ppm = config.sf - 2 if config.reduced_rate else config.sf
    CW = codeword_capacity(config, max_symbols)
    src = np.zeros((4, CW, 8), np.int32)
    shift = np.zeros((4, CW, 8), np.int32)
    mask = np.zeros((4, CW, 8), np.int32)
    for v, cr in enumerate((1, 2, 3, 4)):
        blk = 4 + cr
        nblocks = max_symbols // blk
        for k in range(min(CW, nblocks * ppm)):
            n, x = divmod(k, ppm)
            for i in range(blk):
                src[v, k, i] = n * blk + i
                shift[v, k, i] = (x - i) % ppm
                mask[v, k, i] = 1
    return src, shift, mask


def build_tables(config: LoRaConfig, max_symbols: int) -> dict:
    """Host (numpy) tables of a receiver, in the layout
    :func:`lora_tpu_torch.convert.load_tables` installs. Phases are built
    in float64 and cast once. Above ``FOLD_BUDGET`` entries the fold-DFT
    matrices and the likeness rows are ``None``: Phase B then runs the
    dechirp FFT and table slices instead (SF12 at 250 ksps would otherwise
    hold 1 GB of fold planes)."""
    sps = config.samples_per_symbol
    n_bins = config.number_of_bins
    up, down = build_ideal_chirps(config)
    up_ifreq_v = tiled_upchirp_ifreq(config)
    fold = sps * n_bins <= FOLD_BUDGET
    return dict(
        up=up,
        down=down,
        up_ifreq=instantaneous_frequency_np(up),
        down_ifreq=instantaneous_frequency_np(down),
        up_ifreq_v=up_ifreq_v,
        fold_mat=demod.make_fold_dft(down, sps, n_bins) if fold else None,
        fold_up=demod.make_fold_dft(up, sps, n_bins) if fold else None,
        likeness_rows=(demod.make_likeness_rows(up_ifreq_v, sps, config.decim_factor,
                                                n_bins) if fold else None),
        deint_tables=build_deint_tables(config, max_symbols),
        pay_lut=dec.make_payload_nibble_lut(codeword_capacity(config, max_symbols)),
    )


class DenseReceiver:
    """Block-based multi-packet receiver for one static config.

    ``max_symbols`` bounds the payload symbols per packet (the header
    block's 8 symbols are separate). ``demod_method``: ``"gradient"``,
    ``"fft"`` or ``"auto"`` (see the module). ``fft_drift_pass``: correct
    the fft engine's static window grid for sample-clock drift (``None``:
    on from SF11, where a 30 ppm clock outruns the grid's ``decim/2``
    tolerance within a packet). ``fast_sync``: the gradient engine's sync,
    the CFO-invariant fast one (``None``/``True``) or the reference's
    O(sps^2) sliding search (``False``). ``device``: where the tables live
    and the block is processed; ``None`` is the card, and there is no
    quiet fallback to the CPU when it is missing.
    """

    def __init__(
        self,
        config: LoRaConfig,
        max_candidates: int = 8,
        max_symbols: int = 48,
        sfd_search: int = 12,
        demod_method: str = "auto",
        fft_drift_pass=None,
        fast_sync=None,
        header_checksum: bool = False,
        detect_threshold: float = 0.90,
        low_snr: bool = False,
        device=None,
    ):
        if demod_method == "auto":
            demod_method = ("fft" if config.implicit or config.decim_factor < 4
                            or low_snr else "gradient")
        if demod_method not in ("fft", "gradient"):
            raise ValueError(f"unknown demod_method {demod_method!r}")
        if config.implicit:
            raise NotImplementedError("implicit headers are not ported")
        if low_snr:
            raise NotImplementedError("low_snr mode is not ported")
        self.method = demod_method
        if fft_drift_pass is None:
            fft_drift_pass = demod_method == "fft" and config.sf >= 11
        self.fft_drift_pass = bool(fft_drift_pass)
        self.fast_sync = True if fast_sync is None else bool(fast_sync)
        self.cfg = config
        self.P = int(max_candidates)
        self.S = int(max_symbols)
        self.F = int(sfd_search)
        self.header_checksum = bool(header_checksum)
        self.detect_threshold = float(detect_threshold)
        self.sps = config.samples_per_symbol
        self.n_bins = config.number_of_bins
        self.decim = config.decim_factor
        self.device = resolve_device(device)
        # per-packet region: sync(2) + sfd_search + 2.25 + 8 hdr + S payload
        self.pkt_samples = (self.F + 13 + self.S) * self.sps

        from ..convert import load_tables

        load_tables(self, build_tables(config, self.S))

    # ------------------------------------------------------------------
    def _metrics_planes(self, xf: torch.Tensor):
        """Detection metrics: the kernel for a CUDA tensor, its plain
        version for a CPU one. The metric is conj-invariant, so downlink
        (``conj``) configs use it unchanged."""
        return detection_metrics_kernel(xf, self.sps)

    def _tail_ok(self, starts: torch.Tensor, L: int) -> torch.Tensor:
        """Lanes whose packet region fits inside the block (a clamped lane
        would decode a shifted region)."""
        L_eff = max(L, self.pkt_samples)
        return starts * self.sps + self.pkt_samples <= L_eff

    def _snr_from_energy(self, e1: torch.Tensor, starts: torch.Tensor):
        """SNR by the reference's power queue (lib/decoder_impl.cc:360,
        377-383): the firing window's energy over the energy of the window
        ``MAX_PWR_QUEUE_SIZE - 1 = 3`` windows earlier, clamped at the
        block head (``starts`` is already the rising edge + 1)."""
        K = e1.shape[-1]
        sig = torch.take_along_dim(e1, torch.clamp(starts, max=K - 1).long(), dim=-1)
        noise = torch.take_along_dim(
            e1, torch.clamp(starts - 4, 0, K - 1).long(), dim=-1)
        return (sig / torch.clamp(noise, min=1e-30)).to(torch.float32)

    def _candidate_win(self, planes: torch.Tensor, chan: torch.Tensor,
                       start: torch.Tensor, conj_sign: float):
        """Window slicer over the source planes ``[C, 2, L]`` for lanes
        ``(chan[n], start[n])`` (absolute samples).

        ``start`` is clipped to ``[0, L - pkt]`` and each offset to
        ``[0, pkt - n]``, as the region bounds demand. ``win(off, n)``
        returns complex64 ``[N, n]``: one batched gather per sub-window
        (an ``unfold`` view indexed by lane), converted to float32 and
        conjugated for downlink configs.
        """
        pkt = self.pkt_samples
        L = planes.shape[-1]
        if L < pkt:  # block shorter than one packet region: pad up
            planes = torch.nn.functional.pad(planes, (0, pkt - L))
            L = pkt
        start = torch.clamp(start.long(), 0, L - pkt)

        def win(off, n):
            if isinstance(off, torch.Tensor):
                off = torch.clamp(off.long(), 0, pkt - n)
            else:
                off = min(max(int(off), 0), pkt - n)
            w = planes.unfold(-1, n, 1)[chan, :, start + off]  # [N, 2, n]
            w = w.to(torch.float32)
            return torch.complex(w[:, 0], conj_sign * w[:, 1])

        return win

    def _decode_lane(self, win):
        """Phase B of every lane through the receiver's engine."""
        if self.method == "fft":
            return self._decode_candidate_fft(win)
        return self._decode_candidate_grad(win)

    def _demod_symbol(self, window: torch.Tensor):
        """One gradient-engine symbol of every lane ``[N, sps]``: ``(bin,
        fine_sync)`` int32 ``[N]`` (fine sync 0 with drift correction
        off). The fft engine demodulates its static grid in one batch
        instead (:meth:`_decode_candidate_static`)."""
        b = demod.max_frequency_gradient_idx(window, self.n_bins, self.decim)
        if self.cfg.disable_drift_correction:
            return b, torch.zeros_like(b)
        fine = demod.fine_sync_lag(window, b, self._up_ifreq_v, self.sps, self.decim,
                                   demod.fine_sync_search_space(self.decim))
        return b, fine

    def _decode_candidate_grad(self, win):
        """Gradient-engine Phase B for every lane ``[N]``: the upchirp sync,
        the reference's FIND_SFD walk (:785-818) over ``F`` windows, the
        CFO, then the demod of 8 header + ``S`` payload symbols, each window
        placed by the previous one's fine sync and the drift rate measured
        in the walk. Each of JAX's two scans is a loop over steps here; a
        step runs all lanes at once."""
        cfg = self.cfg
        sps, nb, decim = self.sps, self.n_bins, self.decim
        w2 = win(0, 2 * sps)
        if self.fast_sync:
            # CFO-invariant: the gradient demod is timing-sensitive but
            # CFO-blind, so its sync must be timing-true
            i0 = demod.upchirp_sync_grad(w2, self._up_ifreq, sps, nb, decim)
        else:
            i0 = demod.upchirp_sync_xcorr(w2, self._up_ifreq, sps)[0]
        i0 = i0.long()
        N = i0.shape[0]
        dev = i0.device
        frac_cfo = demod.preamble_cfo(win(i0, 2 * sps), sps, cfg.samp_rate)

        # FIND_SFD walk: a run of <= 2 upchirps clearly shifted against the
        # anchored preamble bin, after >= 2 stable preamble reads, with
        # upchirp likeness, is the sync word (hold alignment, spend no fail
        # budget); every upchirp read feeds the sample-clock drift estimate
        zi = torch.zeros(N, dtype=torch.int64, device=dev)
        p, fails, p_found, d_den, srun, streak = i0, zi, zi, zi, zi, zi
        ref = torch.full((N,), -1, dtype=torch.int64, device=dev)
        found = torch.zeros(N, dtype=torch.bool, device=dev)
        d_num = torch.zeros(N, dtype=torch.float32, device=dev)
        for _ in range(self.F):
            w = win(p, sps)
            c = demod.downchirp_pearson(w, self._down_ifreq, sps)
            hit = (c > 0.96) & ~found
            b = demod.max_frequency_gradient_idx(w, nb, decim).long()
            first = ref < 0
            ref = torch.where(first, b, ref)
            streak = torch.where(first, 1, streak)
            rel = (b - ref) % nb
            dist = torch.minimum(rel, nb - rel)
            likeness = demod.upchirp_likeness(w, b, self._up_ifreq_v, sps, decim)
            is_syncw = (~found & ~hit & (dist > 3) & (srun < 2) & (streak >= 2)
                        & (likeness > demod.SYNC_LIKENESS_MIN))
            is_up = (c < -0.97) & ~is_syncw
            up_open = is_up & ~found & ~hit
            ref = torch.where(up_open & (dist > 3), b, ref)
            streak = torch.where(up_open, torch.where(dist <= 3, streak + 1, 1), streak)
            fine = torch.where(up_open,
                               demod.fine_sync_lag(w, -1, self._up_ifreq_v, sps, decim,
                                                   decim * 4).long(), 0)
            # large lags are resyncs, not drift
            track = up_open & (fine.abs() <= decim // 2)
            d_num = d_num + torch.where(track, fine, 0).to(torch.float32)
            d_den = d_den + track.long()
            fails = torch.where(found | hit | is_up | is_syncw, fails, fails + 1)
            srun = torch.where(is_syncw, srun + 1, srun)
            p_found = torch.where(hit, p, p_found)
            found = found | hit
            p = torch.where(found, p, p + sps + fine)
        sfd_ok = found & (fails <= 4)
        # full-range CFO: the integer-bin part from the SFD downchirp, the
        # fraction from the preamble phase
        coarse = demod.chirp_coarse_cfo(
            win(i0, sps), win(p_found, sps), nb, sps, cfg.samp_rate,
            self._fold_mat, self._fold_up, self._up, self._down)
        cfo = demod.combine_cfo(coarse, frac_cfo, sps, cfg.samp_rate)
        # data starts 2.25 symbols after the SFD (:816,:822), advanced by
        # the measured drift rate; the demod applies the rate open-loop a
        # symbol, so fine sync only carries the residual
        rate = d_num / torch.clamp(d_den, min=1)
        p = (p_found + 2 * sps + cfg.delay_after_sync
             + torch.round(2.25 * rate).to(torch.int64))
        acc = torch.zeros(N, dtype=torch.float32, device=dev)
        words = []
        for k in range(8 + self.S):
            b_full, fine = self._demod_symbol(win(p, sps))
            if k < 8 or cfg.reduced_rate:
                b = torch.floor(b_full / 4.0 + 0.5).to(torch.int32) % cfg.number_of_bins_hdr
            else:
                b = b_full
            words.append(b ^ (b >> 1))
            acc = acc + rate
            dstep = torch.round(acc)
            acc = acc - dstep
            if cfg.disable_drift_correction:
                dstep = torch.zeros_like(dstep)
            p = p + sps + fine.long() + dstep.to(torch.int64)
        ok, pay, plen, hdr = self._finish_decode(torch.stack(words, dim=-1), sfd_ok)
        return ok, pay, plen, hdr, cfo

    def _decode_candidate_fft(self, win):
        """Phase B for every lane: the parabolic fold-DFT sync (without
        fold matrices, the dechirp-FFT coarse sync and an ifreq refine),
        then the static SFD search and symbol demod."""
        w2 = win(0, 2 * self.sps)
        if self._fold_mat is not None:
            i0 = demod.upchirp_sync_parab(w2, self._fold_mat, self.sps, self.decim)
        else:
            i0 = demod.upchirp_sync_coarse_fine(w2, self._down, self._up_ifreq, self.sps,
                                                self.n_bins, self.decim)
        return self._decode_candidate_static(win, i0)

    def _shift_idx(self, windows: torch.Tensor) -> torch.Tensor:
        """Folded dechirp argmax bin: the fold-DFT matmul, or the FFT."""
        if self._fold_mat is not None:
            return demod.fft_shift_idx_mm(windows, self._fold_mat)
        return demod.fft_shift_idx(windows, self._down, self.n_bins, self.sps)

    def _decode_candidate_static(self, win, i0: torch.Tensor):
        """SFD search over ``F`` static symbol offsets from the sync point,
        CFO, and the demod of 8 header + ``S`` payload symbols, batched
        over lanes ``[N]``."""
        cfg = self.cfg
        sps, F, nb = self.sps, self.F, self.n_bins
        dev = i0.device
        sfd_flat = win(i0, F * sps)
        N = sfd_flat.shape[0]
        sfd_wins = sfd_flat.reshape(N, F, sps)
        frac_cfo = demod.preamble_cfo(sfd_flat[:, :2 * sps], sps, cfg.samp_rate)
        cs = demod.downchirp_pearson(sfd_wins, self._down_ifreq, sps)  # [N, F]
        hit = cs > 0.96
        found = hit.any(dim=-1)
        first = torch.argmax(hit.to(torch.int32), dim=-1)  # first hit, else 0
        # fail accounting (reference :805-813): a pre-SFD window that is
        # neither SFD nor upchirp is a miss, except <= 2 recognised
        # sync-word symbols (clearly shifted vs the first window and
        # upchirp-like by the likeness gate)
        sbins = self._shift_idx(sfd_wins)
        rel = (sbins - sbins[:, :1]) % nb
        dist = torch.minimum(rel, nb - rel)
        # fft bins read gradient + 1: the likeness lag uses sbins - 1
        if self._likeness_rows is not None:
            likeness = demod.upchirp_likeness_rows(sfd_wins, sbins - 1,
                                                   self._likeness_rows)
        else:
            likeness = demod.upchirp_likeness(sfd_wins, sbins - 1, self._up_ifreq_v,
                                              sps, self.decim)
        sync_like = (dist > 3) & (likeness > demod.SYNC_LIKENESS_MIN)
        recognised = sync_like & (torch.cumsum(sync_like.to(torch.int32), -1) <= 2)
        before = torch.arange(F, device=dev) < first[:, None]
        fails = (before & ~(cs < -0.97) & ~hit & ~recognised).sum(-1)
        sfd_ok = found & (fails <= 4)
        first = first.to(torch.int32)
        p_found = i0 + first * sps
        lanes = torch.arange(N, device=dev)
        coarse = demod.chirp_coarse_cfo(
            sfd_wins[:, 0], sfd_wins[lanes, first.long()], nb, sps,
            cfg.samp_rate, self._fold_mat, self._fold_up, self._up, self._down)
        cfo = demod.combine_cfo(coarse, frac_cfo, sps, cfg.samp_rate)

        # data starts 2.25 symbols after the SFD start (reference :816,:822)
        p_data = p_found + 2 * sps + cfg.delay_after_sync
        nsym = 8 + self.S
        wins = win(p_data, nsym * sps).reshape(N, nsym, sps)
        if self.fft_drift_pass:
            b_full = self._drift_corrected_bins(wins, first)
        else:
            b_full = self._shift_idx(wins)
        b_full = (b_full - 1) % nb  # fft -> gradient bin convention
        reduced = torch.arange(nsym, device=dev) < 8
        if cfg.reduced_rate:
            reduced = torch.ones_like(reduced)
        b_red = torch.floor(b_full / 4.0 + 0.5).to(torch.int32) % cfg.number_of_bins_hdr
        b = torch.where(reduced, b_red, b_full)
        words = b ^ (b >> 1)
        ok, pay, plen, hdr = self._finish_decode(words, sfd_ok)
        return ok, pay, plen, hdr, cfo

    def _drift_corrected_bins(self, wins: torch.Tensor, first: torch.Tensor):
        """Symbol bins ``[N, nsym]`` corrected for sample-clock drift in
        tone-position space. A window late by ``l`` samples reads its tone
        ``l/decim`` bins high, so the continuous tone position (bin +
        parabolic fraction) less the lateness in bins is the bin a
        re-read window would give. The slip is the median of the first 13
        symbol-to-symbol fraction steps (all in-packet for the shortest
        explicit packet), clamped to 0.3 bins a symbol; lateness counts
        from the sync point, across the SFD search and the 2.25-symbol
        consume."""
        nsym = wins.shape[1]
        b_raw, frac = demod.fft_shift_frac(wins, self._down, self.n_bins, self.sps,
                                           self._fold_mat)
        n_est = min(13, nsym)
        d = frac[:, 1:n_est] - frac[:, :n_est - 1]
        d = (d + 0.5) % 1.0 - 0.5
        slip = torch.clamp(demod.median(d), -0.3, 0.3)           # bins / symbol
        lateness = (first.to(torch.float32)[:, None] + 2.25
                    + torch.arange(nsym, dtype=torch.float32, device=wins.device)
                    ) * slip[:, None]
        return torch.round(b_raw.to(torch.float32) + frac - lateness).to(torch.int32) \
            % self.n_bins

    def _finish_decode(self, words: torch.Tensor, sfd_ok: torch.Tensor):
        """Header parse + payload decode from words ``[N, 8+S]``."""
        cfg = self.cfg
        dev = words.device
        N = words.shape[0]
        ppm_hdr = cfg.sf - 2
        hdr_rows = dec.deinterleave_words(words[:, :8].to(torch.int32), 8, ppm_hdr)
        hdr_bytes = dec.decode_header(hdr_rows[:, :5])
        length, cr, has_crc = dec.parse_header(hdr_bytes)
        paylen = length + MAC_CRC_SIZE * has_crc
        budget = dec.payload_symbol_budget(paylen, cr, cfg.sf, cfg.reduced_rate)
        hdr_ok = (budget <= self.S) & (cr >= 1) & (paylen <= MAX_PAYLOAD)
        if self.header_checksum:
            hdr_ok = hdr_ok & dec.header_checksum_valid(hdr_bytes)

        # payload deinterleave: one bit-gather through the per-CR tables
        ppm_pay = cfg.sf - 2 if cfg.reduced_rate else cfg.sf
        src, shift, mask = self._deint_tables
        CW = src.shape[1]
        pay_words = words[:, 8:].to(torch.int32)
        v = torch.clamp(cr - 1, 0, 3).long()
        src_c, shift_c, mask_c = src[v], shift[v], mask[v]   # [N, CW, 8]
        g = torch.gather(pay_words, 1, src_c.reshape(N, -1).long()).reshape(N, CW, 8)
        bits_ = (g >> shift_c) & mask_c
        weights = torch.arange(8, dtype=torch.int32, device=dev)
        pay_cw = (bits_ << weights).sum(-1, dtype=torch.int32)
        # the payload codewords carried in the header block come first
        codewords = torch.cat([hdr_rows[:, 5:], pay_cw], dim=-1)[:, :CW]
        n_blocks = budget // torch.clamp(cr + 4, min=1)
        n_cw = (ppm_hdr - 5) + n_blocks * ppm_pay
        decoded = dec.decode_payload_lut(codewords, n_cw, cr, self._pay_lut)
        m = min(MAX_PAYLOAD, decoded.shape[-1])
        pay = torch.zeros((N, MAX_PAYLOAD), dtype=torch.uint8, device=dev)
        keep = torch.arange(m, device=dev) < paylen[:, None]
        pay[:, :m] = torch.where(keep, decoded[:, :m], 0).to(torch.uint8)
        return (sfd_ok & hdr_ok, pay, paylen.to(torch.int32),
                hdr_bytes.to(torch.uint8))

    # ------------------------------------------------------------------
    def process_planes(self, xf: torch.Tensor) -> DenseResult:
        """Packed IQ ``[..., 2, L]`` (float32 or bfloat16, on the
        receiver's device) -> :class:`DenseResult`."""
        sps = self.sps
        lead = tuple(xf.shape[:-2])
        L = xf.shape[-1]
        xf = xf.contiguous()
        with full_f32_matmul():
            corr, e1, _ = self._metrics_planes(xf)
            starts, s_valid, n_dropped = candidate_starts(
                corr, self.detect_threshold, self.P,
                suppress=leak_suppression(e1))
            # decode from one window past the rising edge: the edge window
            # may begin before the preamble, one later is inside it
            starts = starts + 1
            s_valid = s_valid & self._tail_ok(starts, L)
            snr = self._snr_from_energy(e1, starts)
            C = math.prod(lead)
            planes = xf.reshape(C, 2, L)
            chan = torch.arange(C, device=xf.device).repeat_interleave(self.P)
            conj_sign = -1.0 if self.cfg.conj else 1.0
            win = self._candidate_win(planes, chan, starts.reshape(-1) * sps,
                                      conj_sign)
            ok, pay, plen, hdr, cfo = self._decode_lane(win)
        shape = lead + (self.P,)
        return DenseResult(
            valid=ok.reshape(shape) & s_valid,
            payload=pay.reshape(shape + (MAX_PAYLOAD,)),
            length=plen.reshape(shape),
            hdr=hdr.reshape(shape + (3,)),
            snr=snr,
            start=starts * sps,
            cfo=cfo.reshape(shape),
            n_dropped=n_dropped,
        )

    def process_pooled_planes(self, xf: torch.Tensor, pool: int,
                              per_channel: int = 4, metrics=None) -> PooledResult:
        """Channel planes ``[C, 2, L]`` -> :class:`PooledResult`: Phase A
        on every channel, then Phase B on the strongest ``pool`` valid
        (channel, window) candidates across all channels. ``metrics``:
        optional precomputed ``(corr, e1, e2)`` ``[C, K]`` of this SF's
        window grid, in place of Phase A. Given metrics, the planes are
        read where they lie (any strides: Phase B gathers its windows from
        a view); without, Phase A's detection kernel reads a contiguous
        copy."""
        if xf.ndim != 3 or xf.shape[1] != 2:
            raise ValueError(f"expected channel planes [C, 2, L], got {tuple(xf.shape)}")
        sps = self.sps
        L = xf.shape[-1]
        with full_f32_matmul():
            if metrics is None:
                xf = xf.contiguous()
                metrics = self._metrics_planes(xf)
            corr, e1, _ = metrics
            chan, win, lane_valid, snr, n_dropped = self._pool_lanes(
                e1, corr, per_channel, pool, L)
            conj_sign = -1.0 if self.cfg.conj else 1.0
            ok, pay, plen, hdr, cfo = self._decode_lane(
                self._candidate_win(xf, chan, win * sps, conj_sign))
        return PooledResult(
            valid=ok & lane_valid,
            channel=chan,
            payload=pay,
            length=plen,
            hdr=hdr,
            snr=snr,
            start=win * sps,
            cfo=cfo,
            n_dropped=n_dropped,
        )

    def _pool_lanes(self, e1: torch.Tensor, corr: torch.Tensor,
                    per_channel: int, pool: int, L: int):
        """Candidate compaction for the pooled path: the strongest ``pool``
        valid (channel, window) pairs across all channels, ranked by window
        energy. Returns ``(chan, win, lane_valid, snr, n_dropped)``: the
        first four ``[min(pool, C * per_channel)]``, ``n_dropped`` a scalar
        counting candidates lost to the per-channel capacity plus valid
        candidates past the pool.

        Ranking by energy, not arrival: the normalized metric is
        scale-invariant, so a strong packet's PFB-sidelobe leakage raises
        candidates on idle neighbours too, tens of dB weaker; they must not
        crowd real packets out. The sort is stable, so ties (every invalid
        lane scores -1) keep channel-major candidate order."""
        starts, s_valid, chan_drop = candidate_starts(
            corr, self.detect_threshold, per_channel, suppress=leak_suppression(e1))
        starts = starts + 1  # see process_planes
        s_valid = s_valid & self._tail_ok(starts, L)
        K = e1.shape[-1]
        cand_e = torch.take_along_dim(e1, torch.clamp(starts, max=K - 1).long(), dim=-1)
        flat_valid = s_valid.reshape(-1)
        score = torch.where(flat_valid, cand_e.reshape(-1), -1.0)
        order = torch.argsort(-score, stable=True)[:pool]
        chan = (order // per_channel).to(torch.int32)
        win = starts.reshape(-1)[order]
        lane_valid = flat_valid[order]
        snr = self._snr_from_energy(e1, starts).reshape(-1)[order]
        pool_drop = torch.clamp(flat_valid.sum(dtype=torch.int32) - pool, min=0)
        n_dropped = chan_drop.sum(dtype=torch.int32) + pool_drop
        return chan, win, lane_valid, snr, n_dropped

    def process(self, x) -> DenseResult:
        """Run the pipeline. ``x``: host complex IQ ``[..., L]``, host
        packed planes ``[..., 2, L]``, or a torch tensor of planes.

        Host complex input is padded by ``pkt_samples`` zeros so packets
        ending at the capture tail keep a full decode region; packed
        input is taken to come with its own tailroom.
        """
        if isinstance(x, torch.Tensor):
            return self.process_planes(x.to(self.device))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            pad = [(0, 0)] * (x.ndim - 1) + [(0, self.pkt_samples)]
            xf = pack_iq(np.pad(x.astype(np.complex64), pad), device=self.device)
        else:
            xf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        return self.process_planes(xf)

    def debug_trace(self, *args, **kwargs):
        """JAX's per-lane intermediate taps: not ported."""
        raise NotImplementedError("debug_trace is not ported")

    def run(self, x, channel_offset: int = 0) -> List[Frame]:
        """Decode a block (1-D or ``[C, L]``) into host :class:`Frame`s."""
        res = self.process(x)
        valid = np.atleast_2d(res.valid.cpu().numpy())
        pay = res.payload.cpu().numpy().reshape(valid.shape + (MAX_PAYLOAD,))
        plen = res.length.cpu().numpy().reshape(valid.shape)
        hdr = res.hdr.cpu().numpy().reshape(valid.shape + (3,))
        snr = res.snr.cpu().numpy().reshape(valid.shape)
        start = res.start.cpu().numpy().reshape(valid.shape)
        cfo = res.cfo.cpu().numpy().reshape(valid.shape)
        frames: List[Frame] = []
        for c in range(valid.shape[0]):
            for k in range(valid.shape[1]):
                if not valid[c, k]:
                    continue
                frames.append(Frame(
                    phy_header=PhyHeader.from_bytes(bytes(hdr[c, k])),
                    payload=bytes(pay[c, k][: plen[c, k]]),
                    snr=float(snr[c, k]),
                    channel=c + channel_offset,
                    sample_index=int(start[c, k]),
                    cfo=float(cfo[c, k]),
                ))
        return frames
