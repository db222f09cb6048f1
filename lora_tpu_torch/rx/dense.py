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

Both engines decode implicit-header frames: the first (reduced-rate)
block is payload, and the frame ends at the first symbol whose energy is
below half the preamble window's (reference :356-357,861-866), on the
fft engine's static grid and on the gradient engine's tracked windows;
every lane runs every step and the stop is a per-lane mask, so a call
makes no host read. ``low_snr`` is the coherent mode (fft engine,
explicit headers): detection by the dechirp-fold peak/mean
(:func:`~lora_tpu_torch.rx.frontend.detection_metrics_dechirp`) and SFD by
comparing the up- and down-dechirped fold peaks, with fold matrices up
to ``LOW_SNR_FOLD_BUDGET`` entries. :meth:`DenseReceiver.debug_trace`
returns every lane's intermediates. Header-checksum verification
(``header_checksum``) is ported, as in JAX.

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
from ..ops.chirp import (build_ideal_chirps, instantaneous_frequency,
                         instantaneous_frequency_np, tiled_upchirp_ifreq)
from ..ops.cuda_kernels import detection_metrics_kernel
from ..ops.xfer import pack_iq
from .frontend import (candidate_starts, detection_metrics, detection_metrics_dechirp,
                       leak_suppression)

MAX_PAYLOAD = 260
FOLD_BUDGET = 16 * 1024 * 1024  # fold-DFT entries (sps * n_bins)
# low_snr needs the fold matrices: up to 64M entries (512 MB of float32
# planes for the two, SF12 at 250 ksps)
LOW_SNR_FOLD_BUDGET = 64 * 1024 * 1024


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


def build_tables(config: LoRaConfig, max_symbols: int,
                 fold_budget: int = FOLD_BUDGET) -> dict:
    """Host (numpy) tables of a receiver, in the layout
    :func:`lora_tpu_torch.convert.load_tables` installs. Phases are built
    in float64 and cast once. Above ``fold_budget`` entries the fold-DFT
    matrices are ``None``, and above ``FOLD_BUDGET`` the likeness rows:
    Phase B then runs the dechirp FFT and table slices instead (SF12 at
    250 ksps would otherwise hold 1 GB of fold planes). ``low_snr``
    receivers pass ``LOW_SNR_FOLD_BUDGET``."""
    sps = config.samples_per_symbol
    n_bins = config.number_of_bins
    up, down = build_ideal_chirps(config)
    up_ifreq_v = tiled_upchirp_ifreq(config)
    fold = sps * n_bins <= FOLD_BUDGET
    folds = sps * n_bins <= fold_budget
    return dict(
        up=up,
        down=down,
        up_ifreq=instantaneous_frequency_np(up),
        down_ifreq=instantaneous_frequency_np(down),
        up_ifreq_v=up_ifreq_v,
        fold_mat=demod.make_fold_dft(down, sps, n_bins) if folds else None,
        fold_up=demod.make_fold_dft(up, sps, n_bins) if folds else None,
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
    O(sps^2) sliding search (``False``). ``low_snr``: the coherent mode
    (fft engine and explicit headers only; ``ValueError`` otherwise, and
    where the fold matrices would pass ``LOW_SNR_FOLD_BUDGET``), with its
    candidate threshold ``low_snr_threshold`` on the peak/mean score
    (``None``: ``1.6 * (ln n_bins + 0.5772)``, ~4 sigma above the noise
    baseline). ``device``: where the tables live and the block is
    processed; ``None`` is the card, and there is no quiet fallback to
    the CPU when it is missing.
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
        low_snr_threshold=None,
        device=None,
    ):
        if demod_method == "auto":
            demod_method = ("fft" if config.implicit or config.decim_factor < 4
                            or low_snr else "gradient")
        if demod_method not in ("fft", "gradient"):
            raise ValueError(f"unknown demod_method {demod_method!r}")
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
        self.low_snr = bool(low_snr)
        if self.low_snr:
            if self.method != "fft":
                raise ValueError("low_snr mode requires the fft engine")
            if self.sps * self.n_bins > LOW_SNR_FOLD_BUDGET:
                raise ValueError(
                    "low_snr mode needs the fold-DFT matrices (sps * n_bins "
                    "<= 64M); decimate closer to critical sampling first")
            if config.implicit:
                raise ValueError(
                    "low_snr mode is explicit-header only (the implicit "
                    "energy-stop is noise-dominated at low SNR)")
        if low_snr_threshold is None:
            low_snr_threshold = 1.6 * (np.log(self.n_bins) + 0.5772)
        self.low_snr_threshold = float(low_snr_threshold)
        self.device = resolve_device(device)
        # per-packet region: sync(2) + sfd_search + 2.25 + 8 hdr + S payload
        self.pkt_samples = (self.F + 13 + self.S) * self.sps

        from ..convert import load_tables

        load_tables(self, build_tables(
            config, self.S, LOW_SNR_FOLD_BUDGET if self.low_snr else FOLD_BUDGET))
        if config.implicit:
            # the implicit tail decodes the header block's rows and every
            # whole block of the configured CR: its own codeword count
            ppm = config.sf - 2 if config.reduced_rate else config.sf
            n_cw = config.sf - 2 + (self.S // (4 + config.cr)) * ppm
            self._pay_lut_implicit = torch.as_tensor(dec.make_payload_nibble_lut(n_cw),
                                                     device=self.device)

    @property
    def _cand_threshold(self) -> float:
        """Candidate threshold of the active detection metric."""
        return self.low_snr_threshold if self.low_snr else self.detect_threshold

    # ------------------------------------------------------------------
    def _metrics_planes(self, xf: torch.Tensor):
        """Detection metrics of contiguous planes: the kernel for a CUDA
        tensor, its plain version for a CPU one. The metric is
        conj-invariant, so downlink (``conj``) configs use it unchanged.
        In ``low_snr`` mode the coherent dechirp-fold metric replaces it
        (a downlink config dechirps with the upchirp)."""
        if self.low_snr:
            fold = self._fold_up if self.cfg.conj else self._fold_mat
            return detection_metrics_dechirp(xf, self.sps, fold)
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

    def _decode_lane(self, win, collect: bool = False):
        """Phase B of every lane through the receiver's engine. With
        ``collect`` the result carries a dict of per-lane intermediates
        (see :meth:`debug_trace`)."""
        if self.method == "fft":
            return self._decode_candidate_fft(win, collect)
        return self._decode_candidate_grad(win, collect)

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

    @staticmethod
    def _energy(w: torch.Tensor) -> torch.Tensor:
        return (w.real ** 2 + w.imag ** 2).sum(-1)

    def _energy_stop(self, e_sym: torch.Tensor, pre: torch.Tensor):
        """Implicit end of frame (reference :356-357,861-864): the first
        symbol of ``e_sym`` ``[N, nsym]`` whose energy is below half the
        preamble window ``pre``'s. ``(ended, n_data)``: whether a symbol
        was, and the symbols before it (``nsym`` where none was)."""
        below = e_sym < (self._energy(pre) / 2.0)[:, None]
        ended = below.any(dim=-1)
        first = torch.argmax(below.to(torch.int32), dim=-1)
        n_data = torch.where(ended, first, e_sym.shape[-1]).to(torch.int32)
        return ended, n_data

    def _decode_candidate_grad(self, win, collect: bool = False):
        """Gradient-engine Phase B for every lane ``[N]``: the upchirp sync,
        the reference's FIND_SFD walk (:785-818) over ``F`` windows, the
        CFO, then the demod of 8 header + ``S`` payload symbols, each window
        placed by the previous one's fine sync and the drift rate measured
        in the walk. Each of JAX's two scans is a loop over steps here; a
        step runs all lanes at once, and every lane runs every step (the
        implicit stop is read after the loop, from each step's energy)."""
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
        sfd_corr, sfd_pos = [], []
        for _ in range(self.F):
            w = win(p, sps)
            c = demod.downchirp_pearson(w, self._down_ifreq, sps)
            if collect:
                sfd_corr.append(c)
                sfd_pos.append(p)
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
        p_data = (p_found + 2 * sps + cfg.delay_after_sync
                  + torch.round(2.25 * rate).to(torch.int64))
        p = p_data
        acc = torch.zeros(N, dtype=torch.float32, device=dev)
        words, energies, bins, fines, pos, spectra = [], [], [], [], [], []
        for k in range(8 + self.S):
            w = win(p, sps)
            b_full, fine = self._demod_symbol(w)
            if k < 8 or cfg.reduced_rate:
                b = torch.floor(b_full / 4.0 + 0.5).to(torch.int32) % cfg.number_of_bins_hdr
            else:
                b = b_full
            words.append(b ^ (b >> 1))
            if cfg.implicit:
                # the energy stop reads the drift-corrected windows
                energies.append(self._energy(w))
            if collect:
                # the gradient demod's view: the bin-averaged ifreq
                ifr = instantaneous_frequency(w)
                spectra.append(ifr[:, :nb * decim].reshape(N, nb, decim).sum(-1) / decim)
                bins.append(b_full)
                fines.append(fine)
                pos.append(p)
            acc = acc + rate
            dstep = torch.round(acc)
            acc = acc - dstep
            if cfg.disable_drift_correction:
                dstep = torch.zeros_like(dstep)
            p = p + sps + fine.long() + dstep.to(torch.int64)
        words = torch.stack(words, dim=-1)
        if cfg.implicit:
            ended, n_data = self._energy_stop(torch.stack(energies, dim=-1), win(i0, sps))
            out = self._finish_decode_implicit(words, sfd_ok & ended, n_data) + (cfo,)
        else:
            out = self._finish_decode(words, sfd_ok) + (cfo,)
        if not collect:
            return out
        i32 = torch.int32
        return out + (dict(
            i0=i0.to(i32), frac_cfo=frac_cfo, coarse_cfo=coarse, cfo=cfo,
            sfd_corr=torch.stack(sfd_corr, dim=-1), sfd_pos=torch.stack(sfd_pos, dim=-1).to(i32),
            p_found=p_found.to(i32), fails=fails.to(i32), sfd_ok=sfd_ok,
            p_data=p_data.to(i32), words=words, bins=torch.stack(bins, dim=-1),
            fine_syncs=torch.stack(fines, dim=-1), window_pos=torch.stack(pos, dim=-1).to(i32),
            spectra=torch.stack(spectra, dim=-2)),)

    def _decode_candidate_fft(self, win, collect: bool = False):
        """Phase B for every lane: the parabolic fold-DFT sync (without
        fold matrices, the dechirp-FFT coarse sync and an ifreq refine),
        then the static SFD search and symbol demod."""
        w2 = win(0, 2 * self.sps)
        if self._fold_mat is not None:
            i0 = demod.upchirp_sync_parab(w2, self._fold_mat, self.sps, self.decim)
        else:
            i0 = demod.upchirp_sync_coarse_fine(w2, self._down, self._up_ifreq, self.sps,
                                                self.n_bins, self.decim)
        return self._decode_candidate_static(win, i0, collect)

    def _shift_idx(self, windows: torch.Tensor) -> torch.Tensor:
        """Folded dechirp argmax bin: the fold-DFT matmul, or the FFT."""
        if self._fold_mat is not None:
            return demod.fft_shift_idx_mm(windows, self._fold_mat)
        return demod.fft_shift_idx(windows, self._down, self.n_bins, self.sps)

    def _sfd_coherent(self, sfd_wins: torch.Tensor):
        """``low_snr`` SFD search over the static windows ``[N, F, sps]``.

        A downchirp window dechirped by the upchirp folds to one tone,
        while its dechirp by the downchirp stays flat, and the other way
        round for preamble upchirps: comparing the two folded peaks tells
        up, down and noise apart with the full ``sps``-sample processing
        gain. Sync-word symbols are upchirp-like (a tone at a shifted bin),
        so they need no likeness gate. Returns ``(cs, hit, first, fails)``
        with ``cs = (pu - pd) / (pu + pd)``, +1 for an SFD-like window."""
        F, nb = self.F, self.n_bins
        pd = demod._fold_power(sfd_wins, self._fold_mat)     # upchirp-tone power
        pu = demod._fold_power(sfd_wins, self._fold_up)      # downchirp-tone power
        pd_peak = pd.amax(dim=-1)
        pu_peak = pu.amax(dim=-1)
        sbins = torch.argmax(pd, dim=-1)
        hit = pu_peak > 2.0 * pd_peak                        # downchirp-like: SFD
        first = torch.argmax(hit.to(torch.int32), dim=-1)
        up_like = pd_peak > 2.0 * pu_peak                    # preamble / sync word
        rel = (sbins - sbins[:, :1]) % nb
        dist = torch.minimum(rel, nb - rel)
        shifted = up_like & (dist > 3)
        recognised = shifted & (torch.cumsum(shifted.to(torch.int32), -1) <= 2)
        before = torch.arange(F, device=sfd_wins.device) < first[:, None]
        fails = (before & ~up_like & ~hit & ~recognised).sum(-1)
        cs = (pu_peak - pd_peak) / torch.clamp(pu_peak + pd_peak, min=1e-30)
        return cs, hit, first, fails

    def _sfd_static(self, sfd_wins: torch.Tensor):
        """SFD search over the static windows ``[N, F, sps]`` by the
        reference's Pearson (:785-818). A pre-SFD window that is neither
        SFD nor upchirp is a miss (:805-813), except <= 2 recognised
        sync-word symbols (clearly shifted against the first window and
        upchirp-like by the likeness gate). Returns ``(cs, hit, first,
        fails)``."""
        sps, F, nb = self.sps, self.F, self.n_bins
        cs = demod.downchirp_pearson(sfd_wins, self._down_ifreq, sps)  # [N, F]
        hit = cs > 0.96
        first = torch.argmax(hit.to(torch.int32), dim=-1)  # first hit, else 0
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
        before = torch.arange(F, device=sfd_wins.device) < first[:, None]
        fails = (before & ~(cs < -0.97) & ~hit & ~recognised).sum(-1)
        return cs, hit, first, fails

    def _decode_candidate_static(self, win, i0: torch.Tensor, collect: bool = False):
        """SFD search over ``F`` static symbol offsets from the sync point,
        CFO, and the demod of 8 header + ``S`` payload symbols, batched
        over lanes ``[N]``. The SFD block's window 0 also serves the
        preamble CFO, the coarse CFO and the implicit energy threshold."""
        cfg = self.cfg
        sps, F, nb = self.sps, self.F, self.n_bins
        dev = i0.device
        sfd_flat = win(i0, F * sps)
        N = sfd_flat.shape[0]
        sfd_wins = sfd_flat.reshape(N, F, sps)
        frac_cfo = demod.preamble_cfo(sfd_flat[:, :2 * sps], sps, cfg.samp_rate)
        if self.low_snr:
            cs, hit, first, fails = self._sfd_coherent(sfd_wins)
        else:
            cs, hit, first, fails = self._sfd_static(sfd_wins)
        sfd_ok = hit.any(dim=-1) & (fails <= 4)
        first = first.to(torch.int32)
        p_found = i0 + first * sps
        lanes = torch.arange(N, device=dev)
        up_win = sfd_wins[:, 0]
        coarse = demod.chirp_coarse_cfo(
            up_win, sfd_wins[lanes, first.long()], nb, sps,
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
        if cfg.implicit:
            # the energy stop on the static grid, against window 0
            ended, n_data = self._energy_stop(self._energy(wins), up_win)
            out = self._finish_decode_implicit(words, sfd_ok & ended, n_data) + (cfo,)
        else:
            out = self._finish_decode(words, sfd_ok) + (cfo,)
        if not collect:
            return out
        steps = torch.arange(nsym, device=dev, dtype=torch.int32)
        return out + (dict(
            i0=i0.to(torch.int32), frac_cfo=frac_cfo, coarse_cfo=coarse, cfo=cfo,
            sfd_corr=cs,
            sfd_pos=i0[:, None] + torch.arange(F, device=dev, dtype=torch.int32) * sps,
            p_found=p_found, fails=fails.to(torch.int32), sfd_ok=sfd_ok,
            p_data=p_data.to(torch.int32), words=words, bins=b_full,
            fine_syncs=torch.zeros((N, nsym), dtype=torch.int32, device=dev),
            window_pos=(p_data[:, None] + steps * sps).to(torch.int32),
            # the folded dechirp magnitudes (the reference's get_shift_fft view)
            spectra=demod.dechirp_fft_mag(wins, self._down, nb, sps)),)

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
        return (sfd_ok & hdr_ok, self._payload_bytes(decoded, paylen),
                paylen.to(torch.int32), hdr_bytes.to(torch.uint8))

    @staticmethod
    def _payload_bytes(decoded: torch.Tensor, paylen: torch.Tensor) -> torch.Tensor:
        """The first ``paylen`` decoded bytes of each lane, zero after,
        in ``[N, MAX_PAYLOAD]`` uint8."""
        N = decoded.shape[0]
        m = min(MAX_PAYLOAD, decoded.shape[-1])
        pay = torch.zeros((N, MAX_PAYLOAD), dtype=torch.uint8, device=decoded.device)
        keep = torch.arange(m, device=decoded.device) < paylen[:, None]
        pay[:, :m] = torch.where(keep, decoded[:, :m], 0).to(torch.uint8)
        return pay

    def _finish_decode_implicit(self, words: torch.Tensor, ok: torch.Tensor,
                                n_data: torch.Tensor):
        """Implicit-header tail from words ``[N, 8+S]``: no header parse;
        the 8 (reduced-rate) header-block symbols are payload, and the
        payload length is half the codewords of the symbols before the
        energy stop, ``n_data`` (reference DECODE_PAYLOAD's implicit branch
        :861-866). The PHY header is made from the config, as the
        reference publishes its constructor-initialised ``d_phdr``."""
        cfg = self.cfg
        dev = words.device
        N = words.shape[0]
        cr = cfg.cr
        ppm_hdr = cfg.sf - 2
        ppm_pay = cfg.sf - 2 if cfg.reduced_rate else cfg.sf
        blk = 4 + cr
        hdr_rows = dec.deinterleave_words(words[:, :8].to(torch.int32), 8, ppm_hdr)
        n_static = self.S // blk
        w = words[:, 8:8 + n_static * blk].to(torch.int32).reshape(N, n_static, blk)
        pay_rows = dec.deinterleave_words(w, blk, ppm_pay).reshape(N, -1)
        codewords = torch.cat([hdr_rows, pay_rows], dim=-1)
        n_blocks = torch.clamp(n_data - 8, min=0) // blk
        n_cw = ppm_hdr + n_blocks * ppm_pay
        paylen = n_cw // 2
        crs = torch.full((N,), cr, dtype=torch.int32, device=dev)
        decoded = dec.decode_payload_lut(codewords, n_cw, crs, self._pay_lut_implicit)
        flags = ((1 if cfg.crc else 0) << 4) | ((cr & 0x7) << 5)
        hdr_bytes = torch.stack([paylen & 0xFF, torch.full_like(paylen, flags),
                                 torch.zeros_like(paylen)], dim=-1).to(torch.uint8)
        ok = ok & (n_data >= 8) & (paylen <= MAX_PAYLOAD)
        return ok, self._payload_bytes(decoded, paylen), paylen.to(torch.int32), hdr_bytes

    # ------------------------------------------------------------------
    def _dense(self, xf: torch.Tensor, corr: torch.Tensor, e1: torch.Tensor,
               conj_sign: float) -> DenseResult:
        """Candidates of every stream of ``xf`` ``[..., 2, L]`` from its
        metrics ``[..., K]``, then Phase B of all ``[..., P]`` lanes."""
        sps = self.sps
        lead = tuple(xf.shape[:-2])
        L = xf.shape[-1]
        starts, s_valid, n_dropped = candidate_starts(
            corr, self._cand_threshold, self.P, suppress=leak_suppression(e1))
        # decode from one window past the rising edge: the edge window
        # may begin before the preamble, one later is inside it
        starts = starts + 1
        s_valid = s_valid & self._tail_ok(starts, L)
        snr = self._snr_from_energy(e1, starts)
        C = math.prod(lead)
        planes = xf.reshape(C, 2, L)
        chan = torch.arange(C, device=xf.device).repeat_interleave(self.P)
        win = self._candidate_win(planes, chan, starts.reshape(-1) * sps, conj_sign)
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

    def process_planes(self, xf: torch.Tensor, metrics=None) -> DenseResult:
        """Packed IQ ``[..., 2, L]`` (float32 or bfloat16, on the
        receiver's device) -> :class:`DenseResult`. ``metrics``: optional
        precomputed ``(corr, e1, e2)`` ``[..., K]`` in place of Phase A.
        Downlink (``conj``) configs negate the imaginary plane as the lanes
        gather their windows."""
        xf = xf.contiguous()
        with full_f32_matmul():
            if metrics is None:
                metrics = self._metrics_planes(xf)
            corr, e1, _ = metrics
            return self._dense(xf, corr, e1, -1.0 if self.cfg.conj else 1.0)

    def _complex_metrics(self, x: torch.Tensor, xf: torch.Tensor):
        """Phase A of complex (already conjugated) IQ: the complex form of
        the autocorrelation metric, or the dechirp metric in ``low_snr``."""
        if self.low_snr:
            return detection_metrics_dechirp(xf, self.sps, self._fold_mat)
        return detection_metrics(x, self.sps)

    def process_complex(self, x: torch.Tensor, metrics=None) -> DenseResult:
        """Complex IQ ``[..., L]`` (complex64, on the receiver's device) ->
        :class:`DenseResult`. ``metrics``: optional precomputed ``(corr, e1,
        e2)`` (dropped for downlink configs, whose input is conjugated
        first). Candidates within the last ``pkt_samples`` are invalid:
        give the block that much tailroom (zeros or the next block's
        halo) to decode packets ending near its end."""
        if self.cfg.conj:
            x = torch.conj(x)
            metrics = None
        xf = torch.stack([x.real, x.imag], dim=-2).to(torch.float32)
        with full_f32_matmul():
            if metrics is None:
                metrics = self._complex_metrics(x, xf)
            corr, e1, _ = metrics
            return self._dense(xf, corr, e1, 1.0)

    def _pooled(self, xf: torch.Tensor, corr: torch.Tensor, e1: torch.Tensor,
                per_channel: int, pool: int, conj_sign: float) -> PooledResult:
        sps = self.sps
        chan, win, lane_valid, snr, n_dropped = self._pool_lanes(
            e1, corr, per_channel, pool, xf.shape[-1])
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
        with full_f32_matmul():
            if metrics is None:
                xf = xf.contiguous()
                metrics = self._metrics_planes(xf)
            corr, e1, _ = metrics
            return self._pooled(xf, corr, e1, per_channel, pool,
                                -1.0 if self.cfg.conj else 1.0)

    def process_pooled(self, x: torch.Tensor, pool: int, per_channel: int = 4,
                       metrics=None) -> PooledResult:
        """:meth:`process_pooled_planes` on complex IQ ``[C, L]`` (complex64,
        on the receiver's device): up to ``per_channel`` candidates a
        channel, the strongest ``pool`` of all channels decoded. Phase B
        costs O(pool), whatever the channel count; candidates past the
        pool are dropped and counted."""
        if self.cfg.conj:
            x = torch.conj(x)
            metrics = None
        xf = torch.stack([x.real, x.imag], dim=-2).to(torch.float32)
        with full_f32_matmul():
            if metrics is None:
                metrics = self._complex_metrics(x, xf)
            corr, e1, _ = metrics
            return self._pooled(xf, corr, e1, per_channel, pool, 1.0)

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
            corr, self._cand_threshold, per_channel, suppress=leak_suppression(e1))
        starts = starts + 1  # see _dense
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

    def _planes_of(self, x) -> torch.Tensor:
        """Planes ``[..., 2, L]`` on the receiver's device from host complex
        IQ, host packed planes, or a tensor of either. Complex input (host
        or tensor) is padded by ``pkt_samples`` zeros so packets ending at
        its tail keep a full decode region; planes are taken to come with
        their own tailroom."""
        pad = self.pkt_samples
        if isinstance(x, torch.Tensor):
            x = x.to(self.device)
            if not x.is_complex():
                return x
            xf = torch.stack([x.real, x.imag], dim=-2).to(torch.float32)
            return torch.nn.functional.pad(xf, (0, pad))
        x = np.asarray(x)
        if np.iscomplexobj(x):
            widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
            return pack_iq(np.pad(x.astype(np.complex64), widths), device=self.device)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def process(self, x) -> DenseResult:
        """Run the pipeline. ``x``: host complex IQ ``[..., L]``, host
        packed planes ``[..., 2, L]``, or a torch tensor of either (a
        complex tensor, such as a channelizer's output, is padded and
        split into planes on its device; see :meth:`_planes_of`)."""
        return self.process_planes(self._planes_of(x))

    def debug_trace(self, x) -> dict:
        """Decode ONE stream with every lane's intermediate taps.

        The analogue of the reference's ``GRLORA_DEBUG`` sample dumps and
        per-symbol log (lib/decoder_impl.cc:63-67,514-516) and of the
        golden receiver's ``DebugTrace``. ``x``: host complex IQ ``[L]``
        (padded as :meth:`process` pads it), host planes ``[2, L]``, or a
        tensor of either. Phase A runs as in :meth:`process_planes` (the
        detection kernel on the card). Returns a dict of host numpy
        arrays:

        block level
            ``corr``/``e1`` dense detection metrics ``[K]``;
            ``starts``/``cand_valid`` candidate starts ``[P]``; ``n_dropped``.
        per candidate (leading axis ``P``)
            ``i0`` sync offset; ``frac_cfo``/``coarse_cfo``/``cfo``;
            ``sfd_corr``/``sfd_pos`` the SFD search ``[F]``;
            ``p_found``/``fails``/``sfd_ok``/``p_data``;
            ``words``/``bins``/``fine_syncs``/``window_pos`` per symbol
            ``[8+S]``; ``spectra`` the per-symbol dechirped view (fft:
            folded magnitudes ``[8+S, n_bins]``; gradient: the bin-averaged
            instantaneous frequency); the decode ``ok``/``payload``/
            ``length``/``hdr``.
        """
        sps = self.sps
        xf = self._planes_of(x).contiguous()
        if xf.ndim != 2:
            raise ValueError(f"debug_trace takes one stream, got planes {tuple(xf.shape)}")
        L = xf.shape[-1]
        with full_f32_matmul():
            corr, e1, _ = self._metrics_planes(xf)
            starts, s_valid, n_dropped = candidate_starts(
                corr, self._cand_threshold, self.P, suppress=leak_suppression(e1))
            starts = starts + 1
            s_valid = s_valid & self._tail_ok(starts, L)
            chan = torch.zeros(self.P, dtype=torch.int64, device=xf.device)
            win = self._candidate_win(xf[None], chan, starts * sps,
                                      -1.0 if self.cfg.conj else 1.0)
            ok, pay, plen, hdr, _, extras = self._decode_lane(win, collect=True)
        out = dict(corr=corr, e1=e1, starts=starts * sps, cand_valid=s_valid,
                   n_dropped=n_dropped, ok=ok & s_valid, payload=pay, length=plen,
                   hdr=hdr, **extras)
        return {k: v.cpu().numpy() for k, v in out.items()}

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
