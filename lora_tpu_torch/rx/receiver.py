"""The parity engine: the reference's state machine, batched over channels.

The port of ``lora_tpu/rx/receiver.py:JaxReceiver``, the reference's
``decoder_impl::work`` loop (``lib/decoder_impl.cc:740-903``) with its seven
states. JAX runs it as one compiled ``lax.while_loop`` over a
``lax.switch``; here the loop is driven from the host over state tensors
that stay on the receiver's device, each with a leading channel axis, so
one call decodes ``C`` streams as JAX's ``vmap`` over the loop would.

One step of the loop:

- the state id of every channel still inside its stream (``p + 2*sps <=
  n``) is read to the host in one small device-to-host copy, the step's
  only host synchronisation; a channel past its end is frozen, as the
  batched ``while_loop`` freezes it, and the loop ends when none is left;
- each state that some channel is in runs its branch once, batched over
  that state's channels, on their ``[2*sps]`` windows taken at their own
  ``p`` by one gather; the results are written back by index. The
  branches differ in cost by orders of magnitude (``sync``'s sliding
  search is O(sps^2) a window, ``detect`` two reductions), so no branch
  runs for a channel that is not in its state;
- JAX's in-branch selects over the whole state become ``torch.where`` on
  each field, the ``[B]`` mask broadcast over the field's trailing axes.

Its per-window DSP is :mod:`lora_tpu_torch.ops.demod`'s, the integer
decode chain the port's :mod:`~lora_tpu_torch.ops.bits` and
:mod:`~lora_tpu_torch.ops.hamming`, as lookup tables of every 8-bit
codeword (exact: every codeword of the demod buffer is below 256).
Rounding follows JAX's: ``torch.round`` rounds half to even as
``jnp.round`` does (PAUSE, the drift step), the reduced-rate bin is
``floor(b/4 + 0.5)``, and the header's payload-symbol budget is float32
arithmetic throughout.

Capacity limits: ``max_frames`` frames a stream in a ring (the last slot
is overwritten past it, counted in ``n_dropped``), ``MAX_CODEWORDS``
payload codewords.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import LoRaConfig, MAC_CRC_SIZE
from ..device import full_f32_matmul, resolve_device
from ..io.frames import Frame, PhyHeader
from ..ops import bits, demod
from ..ops.chirp import build_ideal_chirps, instantaneous_frequency_np, tiled_upchirp_ifreq
from ..ops.hamming import HAMMING84_DECODE_LUT
from ..tables import PRNG_PAYLOAD_CR56, PRNG_PAYLOAD_CR78

# State ids (reference lib/decoder_impl.h:40-48)
DETECT, SYNC, FIND_SFD, PAUSE, DECODE_HEADER, DECODE_PAYLOAD, STOP = range(7)

MAX_CODEWORDS = 544          # >= 525 codewords of an SF12 reduced 257B frame
MAX_DECODED = MAX_CODEWORDS // 2 + 8
MAX_PAYLOAD = 260

# the fields of the ring fetched to the host at the end of a call
_OUT_FIELDS = ("n_frames", "n_total", "out_len", "out_pos", "out_hdr", "out_payload",
               "out_snr")


def _sel(mask: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` of a ``[B]`` mask over fields ``[B, ...]`` (``a`` may
    be a Python scalar)."""
    nd = max(getattr(a, "ndim", 0), b.ndim)
    return torch.where(mask.reshape(mask.shape + (1,) * (nd - 1)), a, b)


class _Sub:
    """The fields of the channels ``idx`` of a state (``None``: all)."""

    def __init__(self, st: Dict[str, torch.Tensor], idx):
        self.st, self.idx = st, idx

    def __getitem__(self, k: str) -> torch.Tensor:
        v = self.st[k]
        return v if self.idx is None else v[self.idx]


class ParityReceiver:
    """Reference-parity receiver for a fixed config, on ``device`` (``None``:
    the card; ``"cpu"`` for the CPU). The counterpart of
    ``lora_tpu/rx/receiver.py:JaxReceiver``.

    :meth:`run` decodes one stream (complex, or packed planes ``[2, L]``),
    :meth:`run_batch` several of one length (complex ``[C, L]`` or planes
    ``[C, 2, L]``) in one loop. After a call, ``steps`` holds the loop's
    steps and ``state_reads`` its device-to-host state reads (one a step,
    and one that finds no channel left)."""

    def __init__(self, config: LoRaConfig, max_frames: int = 16, device=None):
        self.cfg = cfg = config
        self.max_frames = int(max_frames)
        self.device = resolve_device(device)
        self.sps = cfg.samples_per_symbol
        self.n_bins = cfg.number_of_bins
        self.n_bins_hdr = cfg.number_of_bins_hdr
        self.decim = cfg.decim_factor
        self.n_dropped = 0
        self.steps = 0
        self.state_reads = 0

        dev = self.device
        up, down = build_ideal_chirps(cfg)
        f32 = torch.float32
        self._up_ifreq = torch.as_tensor(instantaneous_frequency_np(up), device=dev)
        self._down_ifreq = torch.as_tensor(instantaneous_frequency_np(down), device=dev)
        self._up_ifreq_v = torch.as_tensor(tiled_upchirp_ifreq(cfg), dtype=f32, device=dev)
        # the integer chain as tables of every codeword below 256
        cw = np.arange(256, dtype=np.int64)
        ham = HAMMING84_DECODE_LUT.astype(np.int64)
        self._ham_lut = torch.as_tensor(ham, device=dev)
        self._deshuffle_lut = torch.as_tensor(bits.deshuffle(cw), device=dev)
        self._data_lut = torch.as_tensor(bits.extract_data_only(cw), device=dev)
        t56 = np.zeros(MAX_CODEWORDS, np.int64)
        t78 = np.zeros(MAX_CODEWORDS, np.int64)
        t56[:len(PRNG_PAYLOAD_CR56)] = PRNG_PAYLOAD_CR56[:MAX_CODEWORDS]
        t78[:len(PRNG_PAYLOAD_CR78)] = PRNG_PAYLOAD_CR78[:MAX_CODEWORDS]
        self._prng56 = torch.as_tensor(t56, device=dev)
        self._prng78 = torch.as_tensor(t78, device=dev)
        self._ar8 = torch.arange(8, device=dev)
        self._ar_rows = {n: torch.arange(n, device=dev) for n in {cfg.sf - 2, cfg.sf}}
        self._minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
        self._ar_cw = torch.arange(MAX_CODEWORDS, device=dev)
        self._ar_pay = torch.arange(MAX_PAYLOAD, device=dev)
        self._ar_mf = torch.arange(self.max_frames, device=dev)
        self._branches = (self._detect, self._sync, self._find_sfd, self._pause,
                          self._decode_header_step, self._decode_payload_step, self._stop)

    # ------------------------------------------------------------------
    def _initial_state(self, C: int) -> Dict[str, torch.Tensor]:
        cfg, dev, mf = self.cfg, self.device, self.max_frames
        i64, f32 = torch.int64, torch.float32

        def z(*shape, dtype=i64):
            return torch.zeros((C,) + shape, dtype=dtype, device=dev)

        def full(v):
            return torch.full((C,), v, dtype=i64, device=dev)

        crc = 1 if cfg.crc else 0
        return dict(
            p=z(), state=full(DETECT), words=z(8), n_words=z(),
            demod_buf=z(MAX_CODEWORDS), n_demod=z(),
            hdr_cr=full(cfg.cr), hdr_crc=full(crc),
            # d_phdr starts from the constructor's arguments (reference
            # :72-73); it matters in implicit mode, where no header is read
            hdr_bytes=torch.stack([z(), full((cfg.cr << 5) | (crc << 4)), z()], dim=1),
            payload_symbols=z(), payload_length=z(),
            energy_thresh=z(dtype=f32), corr_fails=z(),
            drift_num=z(dtype=f32), drift_den=z(), drift_acc=z(dtype=f32),
            sync_ref_bin=full(-1), sync_run=z(), sync_streak=z(),
            snr=z(dtype=f32), pwr_queue=z(4, dtype=f32), pwr_len=z(),
            n_frames=z(), n_total=z(),
            out_payload=z(mf, MAX_PAYLOAD, dtype=torch.uint8), out_len=z(mf),
            out_hdr=z(mf, 3, dtype=torch.uint8), out_snr=z(mf, dtype=f32), out_pos=z(mf),
        )

    # ------------------------------------------------------------------
    def _decode_header(self, buf: torch.Tensor, n_demod: torch.Tensor) -> dict:
        """decode(true) + header parse (reference :826-852), JAX's
        ``_decode_header``: the header codewords' fields and the erased
        buffer."""
        cfg = self.cfg
        B = buf.shape[0]
        deshuffled = torch.cat([self._deshuffle_lut[buf[:, :5]],
                                torch.zeros((B, 1), dtype=buf.dtype, device=buf.device)], 1)
        nib = self._ham_lut[deshuffled]          # the header is not whitened
        hdr = torch.stack([(nib[:, 0] << 4) | nib[:, 1], (nib[:, 2] << 4) | nib[:, 3],
                           (nib[:, 4] << 4) | nib[:, 5]], dim=1)
        length = hdr[:, 0]
        cr = torch.clamp((hdr[:, 1] >> 5) & 0x7, max=4)   # clamp, reference :834-835
        has_crc = (hdr[:, 1] >> 4) & 0x1
        payload_length = length + MAC_CRC_SIZE * has_crc
        # payload symbol budget (reference :842-847), float32 throughout:
        # float64 or integer maths gives another ceil at large lengths
        red = 2.0 if cfg.reduced_rate else 0.0
        spb = (cr + 4).to(torch.float32)
        bits_needed = payload_length.to(torch.float32) * 8.0
        symbols_needed = bits_needed * (spb / 4.0) / (float(cfg.sf) - red)
        blocks_needed = torch.ceil(symbols_needed / spb)
        payload_symbols = (blocks_needed * spb).to(torch.int64)
        # erase the 5 header codewords from the stream buffer
        demod_buf = torch.roll(buf, -5, dims=1) * (self._ar_cw < (n_demod - 5)[:, None])
        return dict(demod_buf=demod_buf, n_demod=n_demod - 5, hdr_cr=cr, hdr_crc=has_crc,
                    hdr_bytes=hdr, payload_length=payload_length,
                    payload_symbols=payload_symbols)

    def _decode_payload_bytes(self, buf: torch.Tensor, n_demod: torch.Tensor,
                              cr: torch.Tensor) -> torch.Tensor:
        """decode(false): the masked integer chain over the whole buffer ->
        decoded bytes ``[B, MAX_CODEWORDS // 2]`` uint8."""
        valid = self._ar_cw < n_demod[:, None]
        deshuffled = self._deshuffle_lut[buf] & 0xFF
        prng = torch.where((cr <= 2)[:, None], self._prng56, self._prng78)
        dewhitened = torch.where(valid, deshuffled ^ prng, 0)
        # cr 4/3: hamming84 -> nibbles, pack (n0<<4|n1), swap_nibbles
        nib = self._ham_lut[dewhitened]
        b_ham = bits.swap_nibbles((nib[:, 0::2] << 4) | nib[:, 1::2])
        # cr 2/1: data-bit extraction, pack (second<<4 | first)
        data = self._data_lut[dewhitened]
        b_raw = (data[:, 1::2] << 4) | data[:, 0::2]
        decoded = torch.where((cr >= 3)[:, None], b_ham,
                              torch.where((cr >= 1)[:, None], b_raw, 0))
        return decoded.to(torch.uint8)

    def _emit_frame(self, s, st2: dict, finish: torch.Tensor) -> dict:
        """JAX's ``_emit_frame`` of the channels where ``finish``: the frame
        goes to ring slot ``min(n_frames, max_frames - 1)``."""
        decoded = self._decode_payload_bytes(st2["demod_buf"], st2["n_demod"], s["hdr_cr"])
        n_frames = s["n_frames"]
        k = torch.clamp(n_frames, max=self.max_frames - 1)
        paylen = torch.clamp(st2["payload_length"], max=MAX_PAYLOAD)
        pay = torch.where(self._ar_pay < paylen[:, None], decoded[:, :MAX_PAYLOAD], 0)
        slot = finish[:, None] & (self._ar_mf == k[:, None])          # [B, mf]
        return dict(
            n_frames=torch.where(finish, torch.clamp(n_frames + 1, max=self.max_frames),
                                 n_frames),
            n_total=s["n_total"] + finish.to(torch.int64),
            out_payload=torch.where(slot[:, :, None], pay.to(torch.uint8)[:, None, :],
                                    s["out_payload"]),
            out_len=torch.where(slot, paylen[:, None], s["out_len"]),
            out_hdr=torch.where(slot[:, :, None], s["hdr_bytes"].to(torch.uint8)[:, None, :],
                                s["out_hdr"]),
            out_snr=torch.where(slot, s["snr"][:, None], s["out_snr"]),
            out_pos=torch.where(slot, s["p"][:, None], s["out_pos"]),
        )

    # ------------------------------------------------------------------
    def _demodulate(self, s, window: torch.Tensor, is_first: bool):
        """Reference demodulate() :493-529 as a state update: returns
        ``(updates, fine_sync, block_done)``."""
        cfg = self.cfg
        reduced = is_first or cfg.reduced_rate
        bin_idx = demod.max_frequency_gradient_idx(window, self.n_bins, self.decim).long()
        if not cfg.disable_drift_correction:
            fine = demod.fine_sync_lag(window, bin_idx, self._up_ifreq_v, self.sps, self.decim,
                                       demod.fine_sync_search_space(self.decim)).long()
        else:
            fine = torch.zeros_like(bin_idx)
        if reduced:
            bin_idx = torch.floor(bin_idx / 4.0 + 0.5).long() % self.n_bins_hdr
        word = bin_idx ^ (bin_idx >> 1)

        n_words = s["n_words"]
        words = s["words"].scatter(1, torch.clamp(n_words, max=7)[:, None], word[:, None])
        n_words = n_words + 1
        block_size = torch.full_like(n_words, 8) if is_first else 4 + s["hdr_cr"]
        done = n_words == block_size

        # deinterleave on completion (reference :535-565)
        ppm = (cfg.sf - 2) if reduced else cfg.sf
        rot = bits.rotl(words, self._ar8, ppm)                          # [B, 8]
        x_idx = self._ar_rows[ppm]
        bits_mat = (rot[:, :, None] >> x_idx) & 1                       # [B, 8, ppm]
        in_block = self._ar8 < block_size[:, None]                       # [B, 8]
        rows = torch.sum(torch.where(in_block[:, :, None], bits_mat << self._ar8[:, None], 0),
                         dim=1)                                         # [B, ppm]

        # append the rows once the block is done. JAX writes them at
        # min(pos, MAX_CODEWORDS - 1), so rows past the end all land on the
        # last slot, and its CPU scatter leaves the last of them there; a
        # scatter with duplicate indices is nondeterministic on CUDA, so
        # every clamped row carries that last row's value
        n_demod = s["n_demod"]
        pos = n_demod[:, None] + x_idx
        last = MAX_CODEWORDS - 1
        rows = torch.where(pos >= last, rows[:, -1:], rows)
        buf = s["demod_buf"]
        appended = buf.scatter(1, torch.clamp(pos, max=last), rows)
        upd = dict(
            words=_sel(done, 0, words),
            n_words=torch.where(done, 0, n_words),
            demod_buf=_sel(done, appended, buf),
            n_demod=torch.where(done, torch.clamp(n_demod + ppm, max=MAX_CODEWORDS), n_demod),
        )
        return upd, fine, done

    def _drift_step(self, s):
        """The open-loop clock-drift advance: ``(drift_acc, step)``."""
        rate = s["drift_num"] / torch.clamp(s["drift_den"], min=1)
        acc = s["drift_acc"] + rate
        step = torch.round(acc).long()
        if self.cfg.disable_drift_correction:
            step = torch.zeros_like(step)
        return (acc - step.to(torch.float32)).to(torch.float32), step

    # ---- the seven states ---------------------------------------------
    def _detect(self, s, w2):
        sps = self.sps
        corr, e1, e2 = demod.preamble_autocorr(w2, sps)
        pwr = e1 / sps
        # 4-deep circular queue (reference d_pwr_queue)
        pwr_len = s["pwr_len"]
        queue = _sel(pwr_len >= 4, torch.roll(s["pwr_queue"], -1, dims=1), s["pwr_queue"])
        queue = queue.scatter(1, torch.clamp(pwr_len, max=3)[:, None], pwr[:, None])
        pwr_len = torch.clamp(pwr_len + 1, max=4)
        hit = corr >= 0.90
        ratio = torch.gather(queue, 1, (pwr_len - 1)[:, None])[:, 0] / queue[:, 0]
        return dict(
            energy_thresh=e2 / 2.0, pwr_queue=queue, pwr_len=pwr_len,
            snr=torch.where((pwr_len >= 2) & hit, ratio, s["snr"]),
            corr_fails=torch.where(hit, 0, s["corr_fails"]),
            drift_num=torch.where(hit, 0.0, s["drift_num"]),
            drift_den=torch.where(hit, 0, s["drift_den"]),
            drift_acc=torch.where(hit, 0.0, s["drift_acc"]),
            sync_ref_bin=torch.where(hit, -1, s["sync_ref_bin"]),
            sync_run=torch.where(hit, 0, s["sync_run"]),
            sync_streak=torch.where(hit, 0, s["sync_streak"]),
            state=torch.where(hit, SYNC, DETECT),
            # on a hit, sync one window past the detection edge
            p=s["p"] + sps,
        )

    def _sync(self, s, w2):
        i, _ = demod.upchirp_sync_xcorr(w2, self._up_ifreq, self.sps)
        return dict(p=s["p"] + i.long(), state=torch.full_like(s["state"], FIND_SFD))

    def _find_sfd(self, s, w2):
        sps, decim, n_bins = self.sps, self.decim, self.n_bins
        w = w2[:, :sps]
        c = demod.downchirp_pearson(w, self._down_ifreq, sps)
        found = c > 0.96
        # sync-word recognition: a run of <= 2 upchirps clearly shifted
        # against the anchored preamble bin, after >= 2 stable preamble
        # reads, is the sync word: hold alignment, spend no fail
        b = demod.max_frequency_gradient_idx(w, n_bins, decim).long()
        ref0 = s["sync_ref_bin"]
        first = ref0 < 0
        ref = torch.where(first, b, ref0)
        streak0 = torch.where(first, 1, s["sync_streak"])
        rel = (b - ref) % n_bins
        dist = torch.minimum(rel, n_bins - rel)
        # signal-evidence gate: noise windows keep spending fail budget
        likeness = demod.upchirp_likeness(w, b, self._up_ifreq_v, sps, decim)
        is_syncw = ((~found) & (dist > 3) & (s["sync_run"] < 2) & (streak0 >= 2)
                    & (likeness > demod.SYNC_LIKENESS_MIN))
        is_up = (c < -0.97) & ~is_syncw
        ref = torch.where(is_up & (dist > 3), b, ref)
        streak = torch.where(is_up, torch.where(dist <= 3, streak0 + 1, 1), streak0)
        lag = demod.fine_sync_lag(w, self._minus1, self._up_ifreq_v, sps, decim,
                                  decim * 4).long()
        fine = torch.where(is_up, lag, 0)
        corr_fails = torch.where(found | is_up | is_syncw, s["corr_fails"],
                                 s["corr_fails"] + 1)
        state = torch.where(found, PAUSE, torch.where(corr_fails > 4, DETECT, FIND_SFD))
        fine = torch.where(found, 0, fine)
        # sample-clock drift from the per-upchirp corrections (large lags
        # are resyncs, not drift), fed forward across the blind SFD
        track = is_up & ~found & (fine.abs() <= decim // 2)
        return dict(
            corr_fails=corr_fails, state=state, p=s["p"] + sps + fine,
            drift_num=s["drift_num"] + torch.where(track, fine, 0).to(torch.float32),
            drift_den=s["drift_den"] + track.long(),
            sync_ref_bin=ref,
            # a total per-walk budget, not a resettable run
            sync_run=torch.where(is_syncw, s["sync_run"] + 1, s["sync_run"]),
            sync_streak=streak,
        )

    def _pause(self, s, w2):
        # drift-rate feed-forward across the blind 2.25-symbol SFD region
        rate = s["drift_num"] / torch.clamp(s["drift_den"], min=1)
        corr = torch.round(2.25 * rate).long()
        return dict(state=torch.full_like(s["state"], DECODE_HEADER),
                    p=s["p"] + self.sps + self.cfg.delay_after_sync + corr)

    def _decode_header_step(self, s, w2):
        upd, fine, done = self._demodulate(s, w2[:, :self.sps], is_first=True)
        if self.cfg.implicit:
            hdr = dict(payload_symbols=torch.ones_like(s["payload_symbols"]))
        else:
            hdr = self._decode_header(upd["demod_buf"], upd["n_demod"])
        for k, v in hdr.items():
            upd[k] = _sel(done, v, upd[k] if k in upd else s[k])
        acc, dstep = self._drift_step(s)
        upd.update(state=torch.where(done, DECODE_PAYLOAD, DECODE_HEADER),
                   p=s["p"] + self.sps + fine + dstep, drift_acc=acc)
        return upd

    def _decode_payload_step(self, s, w2):
        cfg, sps = self.cfg, self.sps
        w = w2[:, :sps]
        dem, fine, done = self._demodulate(s, w, is_first=False)
        if cfg.implicit:
            stop = demod.symbol_energy(w) < s["energy_thresh"]
            dec = 0                  # reference :866-867: only explicit decrements
        else:
            stop = torch.zeros_like(done)
            dec = torch.where(done, 4 + s["hdr_cr"], 0)
        # implicit stop: no demod this window (reference :861-864)
        st2 = {k: _sel(stop, s[k], v) for k, v in dem.items()}
        st2["payload_symbols"] = torch.where(stop, 0, s["payload_symbols"] - dec)
        st2["payload_length"] = torch.where(stop, s["n_demod"] // 2, s["payload_length"])
        fine = torch.where(stop, 0, fine)

        finish = st2["payload_symbols"] <= 0
        upd = self._emit_frame(s, st2, finish)
        for k in ("words", "n_words", "demod_buf", "n_demod"):
            upd[k] = _sel(finish, 0, st2[k])
        upd["payload_symbols"] = st2["payload_symbols"]
        upd["payload_length"] = st2["payload_length"]
        acc, dstep = self._drift_step(s)
        upd.update(state=torch.where(finish, DETECT, DECODE_PAYLOAD),
                   p=s["p"] + sps + fine + dstep, drift_acc=acc)
        return upd

    def _stop(self, s, w2):
        return dict(p=s["p"] + self.sps)

    # ------------------------------------------------------------------
    def _index(self, chans: List[int]) -> torch.Tensor:
        """A channel index tensor on the device, copied without a host
        synchronisation (from page-locked memory on the card)."""
        t = torch.tensor(chans, dtype=torch.int64)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def process_complex(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run the state machine over complex streams ``[C, n]`` on the
        receiver's device; returns the final state (tensors ``[C, ...]``
        on the device)."""
        sps = self.sps
        C, n = x.shape
        if self.cfg.conj:
            x = torch.conj_physical(x)
        st = self._initial_state(C)
        # every window of every channel: [C, n - 2*sps + 1, 2*sps], a view
        windows = x.unfold(1, 2 * sps, 1) if n >= 2 * sps else None
        all_c = torch.arange(C, device=self.device)
        self.steps = self.state_reads = 0
        with full_f32_matmul():
            while True:
                # the step's one host synchronisation: the state of every
                # channel still inside its stream (-1: frozen at its end)
                code = torch.where(st["p"] + 2 * sps <= n, st["state"], -1).tolist()
                self.state_reads += 1
                present = sorted(set(code) - {-1})
                if not present:
                    break
                for sid in present:
                    chans = [c for c, v in enumerate(code) if v == sid]
                    idx = None if len(chans) == C else self._index(chans)
                    s = _Sub(st, idx)
                    # p >= 0 always (every branch advances it) and p + 2*sps
                    # <= n for a channel in a state, so the gather needs no
                    # clamp, unlike a dynamic slice
                    w2 = windows[all_c if idx is None else idx, s["p"]]
                    for k, v in self._branches[sid](s, w2).items():
                        v = v.to(st[k].dtype)
                        if idx is None:
                            st[k] = v
                        else:
                            st[k][idx] = v
                self.steps += 1
        return st

    @staticmethod
    def fetch(st: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The frame ring of a final state on the host, in one
        device-to-host copy: ``{field: numpy [C, ...]}``."""
        C = st["n_frames"].shape[0]
        parts = [st[k].reshape(C, -1) for k in _OUT_FIELDS[:-1]]
        parts.append(st["out_snr"].view(torch.int32))
        flat = torch.cat([p.to(torch.int64) for p in parts], dim=1).cpu().numpy()
        out, o = {}, 0
        for k in _OUT_FIELDS:
            shape = st[k].shape[1:]
            n = int(np.prod(shape, dtype=np.int64))
            v = flat[:, o:o + n].reshape((C,) + tuple(shape))
            o += n
            if k == "out_snr":
                v = v.astype(np.int32).view(np.float32)
            out[k] = v
        out["out_payload"] = out["out_payload"].astype(np.uint8)
        out["out_hdr"] = out["out_hdr"].astype(np.uint8)
        return out

    # ------------------------------------------------------------------
    def _streams(self, x, batched: bool) -> torch.Tensor:
        """complex64 ``[C, n]`` on the device from complex or packed
        planes, host or tensor."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if not np.iscomplexobj(x):
                x = x.astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if not x.is_complex():
            x = x.to(torch.float32)
            x = torch.complex(x[..., 0, :], x[..., 1, :])
        x = x.to(torch.complex64)
        return x if batched else x[None]

    def run(self, samples) -> List[Frame]:
        """Decode one stream (complex ``[L]`` or planes ``[2, L]``, host or
        tensor); sets ``n_dropped``."""
        return self.frames_from_state(self.fetch(self.process_complex(
            self._streams(samples, batched=False))))

    def run_batch(self, streams) -> List[Frame]:
        """Decode ``C`` streams of one length (complex ``[C, L]`` or planes
        ``[C, 2, L]``) in one loop: frames by channel, then by time
        (``frame.channel`` the stream's index). ``n_dropped`` sums the
        channels'."""
        host = self.fetch(self.process_complex(self._streams(streams, batched=True)))
        frames, dropped = [], 0
        for c in range(host["n_frames"].shape[0]):
            frames.extend(self.frames_from_state(host, c))
            dropped += self.n_dropped
        self.n_dropped = dropped
        return frames

    def frames_from_state(self, st, channel: int = 0) -> List[Frame]:
        """The frames of channel ``channel`` of a fetched state
        (:meth:`fetch`). Also sets ``self.n_dropped``: frames decoded past
        the ring's ``max_frames`` (they overwrote the last slot; raise
        ``max_frames`` when this is nonzero)."""
        n_frames = int(st["n_frames"][channel])
        self.n_dropped = max(int(st["n_total"][channel]) - n_frames, 0)
        frames = []
        for k in range(n_frames):
            ln = int(st["out_len"][channel, k])
            frames.append(Frame(
                phy_header=PhyHeader.from_bytes(bytes(st["out_hdr"][channel, k])),
                payload=bytes(st["out_payload"][channel, k, :ln]),
                snr=float(st["out_snr"][channel, k]),
                channel=channel,
                sample_index=int(st["out_pos"][channel, k]),
            ))
        return frames
