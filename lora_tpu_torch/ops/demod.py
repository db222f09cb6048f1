"""Demodulation ops of the dense receiver's two engines and the parity engine.

Torch forms of the per-window DSP that the dense receiver's Phase B and
the parity engine (:mod:`lora_tpu_torch.rx.receiver`) run (reference
``lib/decoder_impl.cc``). The parity engine's detection reductions: the
preamble autocorrelation (``detect_preamble_autocorr`` :340-366) and the
symbol energy (``determine_energy`` :368-375). The fft engine's: preamble CFO,
upchirp sync, the SFD Pearson (``detect_downchirp`` :283-298,385-390),
the folded dechirp argmax (``get_shift_fft`` :430-464), its fractional
tone position, the upchirp likeness and the chirp CFO/STO separation.
Each has a fold-DFT form (one matmul through the tables of
:func:`make_fold_dft` and :func:`make_likeness_rows`, built in numpy, in
float64, and cast once) and, for geometries whose tables would not fit, a
no-fold form: the dechirp FFT (``torch.fft.fft``) and a slice of the
tiled upchirp ifreq. The gradient engine's: the ifreq-gradient demod
(:func:`max_frequency_gradient_idx`, :466-491), the clock-drift lag search
(:func:`fine_sync_lag`, ``fine_sync`` :300-338), and its two upchirp
syncs, the reference's sliding search (:func:`upchirp_sync_xcorr`,
:399-413) and the CFO-invariant fast one (:func:`upchirp_sync_grad`).
Every function takes complex64 windows ``[..., n]`` and is batched over
the leading axes; where JAX sliced per lane under ``vmap``, one gather
from a sliding (``unfold``) view serves every lane.

Tie-breaking follows the reference's strict ``>`` scans: ``torch.argmax``
returns the first maximum. ``torch.round`` rounds half to even.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .chirp import instantaneous_frequency

SYNC_LIKENESS_MIN = 0.35  # >= 10-sigma above the noise band, half the
                          # 10 dB-SNR sync-symbol score


def _take(m: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(m, j[..., None], dim=-1)[..., 0]


def _fold_power(windows: torch.Tensor, fold_mat) -> torch.Tensor:
    """Folded dechirp power ``[..., n_bins]`` of complex windows
    ``[..., sps]`` through the fold-DFT planes ``(Er, Ei)``."""
    er, ei = fold_mat
    wr, wi = windows.real, windows.imag
    fr = wr @ er - wi @ ei
    fi = wr @ ei + wi @ er
    return fr * fr + fi * fi


def preamble_autocorr(windows: torch.Tensor, sps: int):
    """Normalised autocorrelation of two consecutive symbols (reference
    ``detect_preamble_autocorr`` :340-366) of complex windows ``[...,
    2*sps]``: ``(autocorr, energy1, energy2)`` float32 ``[...]``, the
    energies total (not per sample) as in the reference. A zero-energy
    window scores 0, where the reference's 0/0 gives NaN: both fail its
    ``>= 0.90`` test."""
    c1 = windows[..., :sps]
    c2 = windows[..., sps:2 * sps]
    dot = torch.sum(c1 * torch.conj(c2), dim=-1)
    e1 = torch.sum(c1.real ** 2 + c1.imag ** 2, dim=-1)
    e2 = torch.sum(c2.real ** 2 + c2.imag ** 2, dim=-1)
    denom = torch.sqrt(e1 * e2)
    ok = denom > 0
    corr = torch.where(ok, dot.abs() / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))
    return corr.to(torch.float32), e1.to(torch.float32), e2.to(torch.float32)


def symbol_energy(window: torch.Tensor) -> torch.Tensor:
    """Total ``|x|^2`` of complex windows ``[..., sps]`` (reference
    ``determine_energy`` :368-375). float32 ``[...]``."""
    return torch.sum(window.real ** 2 + window.imag ** 2, dim=-1).to(torch.float32)


def preamble_cfo(x2: torch.Tensor, sps: int, samp_rate: float) -> torch.Tensor:
    """CFO from two adjacent preamble symbols ``[..., 2*sps]``: a carrier
    offset ``f`` rotates symbol k+1 against symbol k by
    ``2*pi*f*sps/fs``, so ``angle(sum x[t+sps] conj(x[t]))`` recovers
    ``f`` within ``+-fs/(2*sps)``."""
    a = x2[..., :sps]
    b = x2[..., sps:2 * sps]
    d = torch.sum(b * torch.conj(a), dim=-1)
    ang = torch.atan2(d.imag, d.real)
    return (ang / (2.0 * math.pi * sps) * samp_rate).to(torch.float32)


def upchirp_sync_parab(windows2: torch.Tensor, fold_mat, sps: int,
                       decim: int) -> torch.Tensor:
    """Upchirp boundary offset in ``[0, sps + 2*decim)`` from one fold-DFT
    matmul and a parabolic vertex over the three folded powers around the
    argmax. The repeated preamble dechirps to one continuous tone whose
    fractional bin gives the boundary to ~``decim/5`` samples, inside the
    fft demod's ``+-decim/2`` alignment tolerance. int32 ``[...]``."""
    j, p = _parab_frac(_fold_power(windows2[..., :sps], fold_mat))
    d0 = sps - (j.to(torch.float32) + p) * decim
    return torch.clamp(torch.round(d0), 0, sps + 2 * decim - 1).to(torch.int32)


def _ifreq_refine(windows2: torch.Tensor, d0: torch.Tensor, upchirp_ifreq: torch.Tensor,
                  sps: int, decim: int) -> torch.Tensor:
    """The best of ``span = 4*decim + 1`` ifreq cross-correlations against
    the ideal upchirp around the coarse boundary ``d0 - 2*decim`` (its
    start clamped into the window pair). The lag rows of every lane are one
    gather from a sliding view of the ifreq. int32 ``[...]``."""
    span = 4 * decim + 1
    ref = upchirp_ifreq[:sps - 1]
    ifr = instantaneous_frequency(windows2)                     # [..., 2*sps]
    base0 = torch.clamp(d0 - 2 * decim, 0, 2 * sps - (span + sps - 2)).long()
    lag_rows = ifr.unfold(-1, sps - 1, 1)                       # [..., sps + 2, sps - 1]
    idx = base0[..., None] + torch.arange(span, device=base0.device)
    rows = torch.take_along_dim(lag_rows, idx[..., None], dim=-2)  # [..., span, sps - 1]
    c = rows @ ref
    return (base0 + torch.argmax(c, dim=-1)).to(torch.int32)


def upchirp_sync_coarse_fine(windows2: torch.Tensor, downchirp: torch.Tensor,
                             upchirp_ifreq: torch.Tensor, sps: int, n_bins: int,
                             decim: int, fold_mat=None) -> torch.Tensor:
    """Upchirp boundary offset in ``[0, sps + 2*decim)``: the dechirped
    tone bin ``b`` (the dechirp FFT's, or the fold-DFT matmul's when
    ``fold_mat`` is given) gives the boundary to ``decim/2`` (``d0 = sps -
    b*decim``), and :func:`_ifreq_refine` gives it exactly. int32
    ``[...]``."""
    if fold_mat is not None:
        b = fft_shift_idx_mm(windows2[..., :sps], fold_mat)
    else:
        b = fft_shift_idx(windows2[..., :sps], downchirp, n_bins, sps)
    return _ifreq_refine(windows2, sps - b * decim, upchirp_ifreq, sps, decim)


def upchirp_sync_grad(windows2: torch.Tensor, upchirp_ifreq: torch.Tensor, sps: int,
                      n_bins: int, decim: int) -> torch.Tensor:
    """CFO-invariant upchirp boundary offset for the gradient engine. The
    coarse estimate is the ifreq wrap position (:func:`max_frequency_gradient_idx`),
    which a carrier offset cannot move, read from the leading window and
    from one half a symbol later (their boundaries differ by ``sps/2``);
    the estimate whose wrap bin is further from the window edges wins, and
    :func:`_ifreq_refine` recovers the exact offset. A dechirp-tone sync
    would fold integer-bin CFO into the timing, which the CFO-blind
    gradient demod turns into a bin error on every symbol. int32 ``[...]``."""
    w_a = windows2[..., :sps]
    w_b = windows2[..., sps // 2:sps // 2 + sps]
    b_a = max_frequency_gradient_idx(w_a, n_bins, decim)
    b_b = max_frequency_gradient_idx(w_b, n_bins, decim)
    d_a = (sps - (b_a + 1) * decim) % sps
    d_b = (sps - (b_b + 1) * decim + sps // 2) % sps
    cent_a = torch.minimum(b_a + 1, n_bins - 1 - b_a)
    cent_b = torch.minimum(b_b + 1, n_bins - 1 - b_b)
    d0 = torch.where(cent_a >= cent_b, d_a, d_b)
    return _ifreq_refine(windows2, d0, upchirp_ifreq, sps, decim)


def _sliding_dot(x: torch.Tensor, ref: torch.Tensor, n_offsets: int) -> torch.Tensor:
    """``out[..., i] = sum_k x[..., i+k] * ref[k]`` for ``i < n_offsets``:
    one ``conv1d`` (a cross-correlation) of every row with ``ref``, in
    full float32 under :func:`~lora_tpu_torch.device.full_f32_matmul`
    (cuDNN's TF32 off)."""
    m = ref.shape[-1]
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    out = torch.nn.functional.conv1d(flat[..., :n_offsets + m - 1],
                                     ref.reshape(1, 1, m).to(x.dtype))
    return out.reshape(lead + (n_offsets,))


def upchirp_sync_xcorr(windows2: torch.Tensor, upchirp_ifreq: torch.Tensor, sps: int):
    """The reference's sliding upchirp search over a 2-symbol window
    ``[..., 2*sps]``: ``(index, max_corr)``, the offset in ``[0, sps)``
    maximising the (unnormalised) ifreq dot product with the ideal upchirp
    over ``sps - 1`` samples (int32), and that maximum (float32). O(sps^2)
    a window; :func:`upchirp_sync_grad` is the engine's default."""
    ifr = instantaneous_frequency(windows2)
    corr = _sliding_dot(ifr, upchirp_ifreq[:sps - 1], sps)     # [..., sps]
    idx = torch.argmax(corr, dim=-1)
    return idx.to(torch.int32), _take(corr, idx).to(torch.float32)


def fft_shift_idx_mm(windows: torch.Tensor, fold_mat) -> torch.Tensor:
    """Folded dechirp argmax bin of ``[..., sps]`` windows (not yet
    dechirped: the matrix carries the chirp). int32 ``[...]``."""
    return torch.argmax(_fold_power(windows, fold_mat), dim=-1).to(torch.int32)


def dechirp_fft_mag(windows: torch.Tensor, downchirp: torch.Tensor,
                    n_bins: int, sps: int) -> torch.Tensor:
    """Folded dechirp FFT magnitudes ``[..., n_bins]`` of ``[..., sps]``
    windows: FFT bins ``[0, (n_bins+1)//2)`` and ``[sps - n_bins//2,
    sps)``, with bin ``n_bins//2`` added into folded bin ``n_bins//2``
    (the reference's ``d_tmp[N/2] += d_fft[N/2]``, :443-456)."""
    f = torch.fft.fft(windows * downchirp, dim=-1)
    folded = torch.cat([f[..., :(n_bins + 1) // 2], f[..., sps - n_bins // 2:]], dim=-1)
    folded[..., n_bins // 2] += f[..., n_bins // 2]
    return folded.abs()


def fft_shift_idx(windows: torch.Tensor, downchirp: torch.Tensor,
                  n_bins: int, sps: int) -> torch.Tensor:
    """Folded dechirp FFT argmax bin (reference ``get_shift_fft``), the
    no-fold form of :func:`fft_shift_idx_mm`. int32 ``[...]``."""
    return torch.argmax(dechirp_fft_mag(windows, downchirp, n_bins, sps),
                        dim=-1).to(torch.int32)


def _parab_frac(m: torch.Tensor):
    """Argmax of ``m`` ``[..., n]`` (int32) and the fractional offset of
    the three-point parabolic vertex around it, in (-0.5, 0.5) (float32)."""
    n = m.shape[-1]
    j = torch.argmax(m, dim=-1)
    m0 = _take(m, j)
    ml = _take(m, (j - 1) % n)
    mr = _take(m, (j + 1) % n)
    denom = ml - 2.0 * m0 + mr
    p = torch.where(denom.abs() > 1e-20, 0.5 * (ml - mr) / denom,
                    torch.zeros_like(denom))
    return j.to(torch.int32), p.to(torch.float32)


def fft_shift_frac(windows: torch.Tensor, downchirp: torch.Tensor, n_bins: int,
                   sps: int, fold_mat=None):
    """Dechirped tone bin (int32) and fractional offset (float32) of each
    window. The vertex is taken of the folded power with a fold matrix
    and of the folded magnitude without one, as the reference receiver
    does. The fraction is data-independent (data shifts are whole bins):
    its symbol-to-symbol slope is the sample-clock slip."""
    if fold_mat is not None:
        m = _fold_power(windows, fold_mat)
    else:
        m = dechirp_fft_mag(windows, downchirp, n_bins, sps)
    return _parab_frac(m)


def median(d: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for
    an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(d, dim=-1).values
    n = d.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def chirp_coarse_cfo(up_window: torch.Tensor, sfd_window: torch.Tensor,
                     n_bins: int, sps: int, samp_rate: float,
                     fold_down, fold_up, upchirp=None,
                     downchirp=None) -> torch.Tensor:
    """Coarse full-range CFO by chirp CFO/STO separation: a carrier offset
    moves the dechirped tone of an upchirp and of a downchirp the same
    way, a timing offset moves them oppositely, so the mean of the two
    signed bins is the integer-bin CFO. Through the fold matrices when
    both are given, else through the dechirp FFT with ``downchirp`` and
    ``upchirp``. Hz, float32 ``[...]``."""
    if fold_down is not None and fold_up is not None:
        b_up = fft_shift_idx_mm(up_window, fold_down)
        b_dn = fft_shift_idx_mm(sfd_window, fold_up)
    else:
        b_up = fft_shift_idx(up_window, downchirp, n_bins, sps)
        b_dn = fft_shift_idx(sfd_window, upchirp, n_bins, sps)
    s_up = torch.where(b_up > n_bins // 2, b_up - n_bins, b_up)
    s_dn = torch.where(b_dn > n_bins // 2, b_dn - n_bins, b_dn)
    return ((s_up + s_dn).to(torch.float32) / 2.0) * (samp_rate / sps)


def combine_cfo(coarse_hz: torch.Tensor, frac_hz: torch.Tensor, sps: int,
                samp_rate: float) -> torch.Tensor:
    """Snap the coarse estimate (full range, half-bin resolution) to the
    total consistent with the fine one (one-bin range)."""
    bin_hz = samp_rate / sps
    n = torch.round((coarse_hz - frac_hz) / bin_hz)
    return (frac_hz + n * bin_hz).to(torch.float32)


def determine_cfo_dechirp(window: torch.Tensor, downchirp: torch.Tensor,
                          samp_rate: float) -> torch.Tensor:
    """The reference's CFO probe (lib/decoder_impl.cc:729-738, whose
    result nothing reads): the dechirped window's instantaneous frequency
    at sample 256 (the last, for shorter windows), in Hz. ``window``
    complex64 ``[..., n]``, ``downchirp`` ``[n]`` on its device."""
    ifr = instantaneous_frequency(window * downchirp)
    idx = min(256, ifr.shape[-1] - 1)
    return (ifr[..., idx] / (2.0 * math.pi) * samp_rate).to(torch.float32)


def downchirp_pearson(window: torch.Tensor, downchirp_ifreq: torch.Tensor,
                      sps: int) -> torch.Tensor:
    """Pearson correlation with the ideal downchirp ifreq over the first
    ``sps-1`` samples (reference ``cross_correlate_ifreq`` with
    ``to_idx = sps-1``: biased deviations, divided by ``to_idx``), in the
    single-pass moment form. A zero-variance window scores 0, which fails
    both SFD thresholds as the reference's NaN does. float32 ``[...]``."""
    n = sps - 1
    x = instantaneous_frequency(window)[..., :n]
    y = downchirp_ifreq[:n]
    yc = y - y.mean()
    sy = torch.sqrt(torch.mean(yc * yc))
    mx = x.sum(dim=-1) / n
    ex2 = (x * x).sum(dim=-1) / n
    var = torch.clamp(ex2 - mx * mx, min=0.0)
    sx = torch.sqrt(var)
    num = x @ yc
    denom = sx * sy
    ok = denom > 0
    c = torch.where(ok, num / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(num))
    return (c / n).to(torch.float32)


def upchirp_likeness_rows(window: torch.Tensor, bin_idx: torch.Tensor,
                          rows) -> torch.Tensor:
    """Pearson of ``ifreq(window)`` against the ideal upchirp ifreq at the
    demodulated bin's own lag, through the precomputed centred rows of
    :func:`make_likeness_rows`: evidence that a window holds a genuine,
    possibly shifted, upchirp. The row is picked by a gather, which is
    exact as the one-hot matmul is. float32 ``[...]``."""
    rows_c, inv = rows
    n_bins, n = rows_c.shape
    ifr = instantaneous_frequency(window)[..., :n]
    b = (bin_idx % n_bins).long()
    ref = rows_c[b]
    ref_inv = inv[b]
    x = ifr - ifr.mean(dim=-1, keepdim=True)
    num = (x * ref).sum(dim=-1)
    xn = torch.sqrt((x * x).sum(dim=-1))
    ok = xn > 0
    c = torch.where(ok, num * ref_inv / torch.where(ok, xn, torch.ones_like(xn)),
                    torch.zeros_like(num))
    return c.to(torch.float32)


def upchirp_likeness(window: torch.Tensor, bin_idx: torch.Tensor,
                     upchirp_ifreq_tiled: torch.Tensor, sps: int,
                     decim: int) -> torch.Tensor:
    """:func:`upchirp_likeness_rows` without the precomputed rows: the
    reference row of each window is the slice of the tiled upchirp ifreq
    at ``(bin + 1)*decim + sps`` (its start clamped into the table, as a
    dynamic slice is), taken by one gather from a sliding view of the
    table. float32 ``[...]``."""
    n = sps - 1
    ifr = instantaneous_frequency(window)[..., :n]
    base = torch.clamp((bin_idx.long() + 1) * decim + sps, 0,
                       upchirp_ifreq_tiled.shape[-1] - n)
    ref = upchirp_ifreq_tiled.unfold(0, n, 1)[base]           # [..., n]
    x = ifr - ifr.mean(dim=-1, keepdim=True)
    y = ref - ref.mean(dim=-1, keepdim=True)
    num = (x * y).sum(dim=-1)
    den = torch.sqrt((x * x).sum(dim=-1) * (y * y).sum(dim=-1))
    ok = den > 0
    c = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                    torch.zeros_like(num))
    return c.to(torch.float32)


def make_fold_dft(chirp: np.ndarray, sps: int, n_bins: int):
    """Dechirp + fold + DFT as one ``[sps, n_bins]`` complex matrix ``E``
    with ``folded_spectrum(w) = w @ E``: the fold keeps FFT bins
    ``[0, (N+1)/2)`` and ``[sps - N/2, sps)`` and adds bin ``N/2`` into
    bin ``N/2`` (reference lib/decoder_impl.cc:443-456). Built in float64;
    returns ``(Er, Ei)`` float32 numpy."""
    k = np.arange(sps)
    h = (n_bins + 1) // 2
    cols = np.empty((sps, n_bins), np.complex128)
    for j in range(n_bins):
        b = j if j < h else sps - n_bins // 2 + (j - h)
        e = np.exp(-2j * np.pi * k * b / sps)
        if j == n_bins // 2:
            e = e + np.exp(-2j * np.pi * k * (n_bins // 2) / sps)
        cols[:, j] = e
    E = np.asarray(chirp)[:, None] * cols
    return E.real.astype(np.float32), E.imag.astype(np.float32)


def make_likeness_rows(upchirp_ifreq_tiled: np.ndarray, sps: int,
                       decim: int, n_bins: int):
    """Centred reference rows of the upchirp likeness for every bin: row
    ``b`` is the tiled upchirp ifreq at offset ``(b+1)*decim + sps``.
    Returns ``(rows_c [n_bins, sps-1], inv_norm [n_bins])`` float32."""
    n = sps - 1
    t = np.asarray(upchirp_ifreq_tiled)
    idx = ((np.arange(n_bins)[:, None] + 1) * decim + sps
           + np.arange(n)[None, :])
    rows = t[idx]
    rows_c = rows - rows.mean(axis=-1, keepdims=True)
    norm = np.sqrt((rows_c * rows_c).sum(axis=-1))
    inv = np.where(norm > 0, 1.0 / np.where(norm > 0, norm, 1.0), 0.0)
    return rows_c.astype(np.float32), inv.astype(np.float32)


def max_frequency_gradient_idx(window: torch.Tensor, n_bins: int, decim: int) -> torch.Tensor:
    """The gradient demod (reference :466-491): the bin of the largest
    negative ifreq step between adjacent bin averages of ``[..., sps]``
    windows. Threshold 0.1; the scan starts at bin 1 and stores ``i + 1``;
    the result is ``(n_bins - max_index) % n_bins`` with ``max_index = 0``
    when no step passes. The last bin's average leaves out its final
    ``max(decim // 2, 2)`` samples (none at ``decim <= 2``): a window late
    by up to half a bin keeps the channel filter's glitch into the next
    symbol out of the argmax, and every true wrap lies left of that tail.
    int32 ``[...]``."""
    ifr = instantaneous_frequency(window)
    use = ifr[..., :n_bins * decim].reshape(ifr.shape[:-1] + (n_bins, decim))
    sums = use.sum(-1)
    trim = max(decim // 2, 2) if decim > 2 else 0
    if trim:
        tail = use[..., -1, decim - trim:].sum(-1)
        last = (sums[..., -1] - tail) / (decim - trim)
        avg = torch.cat([sums[..., :-1] / decim, last[..., None]], dim=-1)
    else:
        avg = sums / decim
    grad = avg[..., :-1] - avg[..., 1:]     # grad[i-1] = avg[i-1] - avg[i]
    best = torch.argmax(grad, dim=-1)       # the first maximum, as a strict > scan
    found = _take(grad, best) > 0.1
    max_index = torch.where(found, best + 2, 0)
    return ((n_bins - max_index) % n_bins).to(torch.int32)


def fine_sync_search_space(decim: int) -> int:
    """The per-symbol drift-search budget of :func:`fine_sync_lag`:
    ``max(decim // 4, 2)`` (reference :502), lags up to +-1 at decimation
    8. A wider search wins wrong large lags over a long packet (a window
    late by a whole bin reads as the next bin)."""
    return max(decim // 4, 2)


def fine_sync_lag(window: torch.Tensor, bin_idx, upchirp_ifreq_tiled: torch.Tensor,
                  sps: int, decim: int, search_space: int) -> torch.Tensor:
    """Clock-drift lag search (reference ``fine_sync`` :300-338) of
    ``[..., sps]`` windows with demodulated bins ``bin_idx`` (int ``[...]``
    or a Python int for all): ``-lag`` (int32 ``[...]``) for the lag in
    ``(-search_space, search_space)`` that maximises the ifreq dot product
    with the tiled ideal upchirp at ``(bin + 1)*decim + sps + lag``; 0 when
    no correlation is positive (strict ``>`` from a zero start). Each
    lane's lag rows are one gather from a sliding view of the table, whose
    section start is clamped into it as a dynamic slice is."""
    ifr = instantaneous_frequency(window)                       # [..., sps]
    dev = ifr.device
    lags = torch.arange(-search_space + 1, search_space, device=dev)
    n_lags = lags.shape[0]
    bin_idx = torch.as_tensor(bin_idx, device=dev).long()
    base = (bin_idx + 1) * decim + sps
    start = torch.clamp(base + lags[0], 0, upchirp_ifreq_tiled.shape[-1] - (sps + n_lags - 1))
    start = start.expand(ifr.shape[:-1])
    rows = upchirp_ifreq_tiled.unfold(0, sps, 1)[start[..., None] + torch.arange(n_lags, device=dev)]
    corr = (rows @ ifr[..., None])[..., 0]                      # [..., n_lags]
    best = torch.argmax(corr, dim=-1)
    pos = _take(corr, best) > 0.0
    lag = torch.where(pos, lags[best], 0)
    return (-lag).to(torch.int32)
