"""Host (numpy) window DSP of the golden receiver.

The golden receiver (:mod:`lora_tpu_torch.rx.golden`) is the sequential
numpy model of the reference's state machine. Its per-window helpers are
kept here in numpy, apart from the batched torch forms in
:mod:`lora_tpu_torch.ops.demod`, so that its decisions come from the same
float32 arithmetic, in the same order, as the reference model's:

- :func:`preamble_autocorr`          <- ``detect_preamble_autocorr`` (:340-366)
- :func:`symbol_energy`              <- ``determine_energy`` (:368-375)
- :func:`upchirp_sync_xcorr`         <- ``sliding_norm_cross_correlate_upchirp`` (:399-413)
- :func:`downchirp_pearson`          <- ``detect_downchirp`` (:283-298,385-390)
- :func:`upchirp_likeness`           the sync-word evidence gate
- :func:`max_frequency_gradient_idx` <- (:466-491), the default demod
- :func:`fine_sync_lag`              <- ``fine_sync`` (:300-338)

Every function is batched over leading axes; argmax ties go to the first
maximum, as the reference's strict ``>`` scans do.
"""

from __future__ import annotations

import numpy as np

from ..ops.chirp import instantaneous_frequency_np as instantaneous_frequency
from ..ops.demod import SYNC_LIKENESS_MIN, fine_sync_search_space  # noqa: F401


def preamble_autocorr(windows, sps: int):
    """Normalized autocorrelation of two consecutive symbols ``[...,
    2*sps]``: ``(autocorr, energy1, energy2)`` float32, the energies total
    (not per sample) as in the reference; 0 where an energy is 0 (the
    reference's NaN fails its threshold the same way)."""
    c1 = windows[..., :sps]
    c2 = windows[..., sps:2 * sps]
    dot = np.sum(c1 * np.conj(c2), axis=-1)
    e1 = np.sum(np.real(c1) ** 2 + np.imag(c1) ** 2, axis=-1)
    e2 = np.sum(np.real(c2) ** 2 + np.imag(c2) ** 2, axis=-1)
    denom = np.sqrt(e1 * e2)
    autocorr = np.where(denom > 0, np.abs(dot) / np.where(denom > 0, denom, 1.0), 0.0)
    return autocorr.astype("float32"), e1.astype("float32"), e2.astype("float32")


def symbol_energy(window):
    """Total ``|x|^2`` over one symbol window (reference :368-375)."""
    return np.sum(np.real(window) ** 2 + np.imag(window) ** 2, axis=-1).astype("float32")


def upchirp_sync_xcorr(windows2, upchirp_ifreq, sps: int):
    """Sliding upchirp alignment over a 2-symbol window ``[..., 2*sps]``:
    ``(index, max_corr)``, the offset in ``[0, sps)`` maximising the
    (unnormalized) ifreq dot product with the ideal upchirp over ``sps-1``
    samples."""
    ifr = instantaneous_frequency(windows2)
    ref = np.asarray(upchirp_ifreq[:sps - 1])
    w = np.lib.stride_tricks.sliding_window_view(ifr, len(ref), axis=-1)[..., :sps, :]
    corr = w @ ref
    idx = np.argmax(corr, axis=-1)
    return idx.astype("int32"), np.max(corr, axis=-1).astype("float32")


def downchirp_pearson(window, downchirp_ifreq, sps: int):
    """Pearson correlation with the ideal downchirp ifreq over the first
    ``sps-1`` samples (biased deviations, divided by ``sps-1``), in the
    single-pass moment form; 0 for a zero-variance window."""
    n = sps - 1
    x = instantaneous_frequency(window)[..., :n]
    y = downchirp_ifreq[:n]
    yc = y - np.mean(y)
    sy = np.sqrt(np.mean(yc * yc))
    mx = np.sum(x, axis=-1) / n
    ex2 = np.sum(x * x, axis=-1) / n
    var = np.maximum(ex2 - mx * mx, 0.0)
    sx = np.sqrt(var)
    num = x @ yc.astype(x.dtype)
    denom = sx * sy
    c = np.where(denom > 0, num / np.where(denom > 0, denom, 1.0), 0.0)
    return (c / n).astype("float32")


def upchirp_likeness(window, bin_idx, upchirp_ifreq_tiled, sps: int, decim: int):
    """Pearson of ``ifreq(window)`` against the ideal upchirp ifreq at the
    demodulated (gradient-convention) bin's own lag, ``(bin + 1)*decim +
    sps`` into the tiled table: ~1 for any true, possibly shifted,
    upchirp, ~0 for noise."""
    n = sps - 1
    ifr = instantaneous_frequency(window)[..., :n]
    base = (np.asarray(bin_idx) + 1) * decim + sps
    idx = base[..., None] + np.arange(n)
    ref = np.take(np.asarray(upchirp_ifreq_tiled), idx, axis=-1)
    x = ifr - np.mean(ifr, axis=-1, keepdims=True)
    y = ref - np.mean(ref, axis=-1, keepdims=True)
    num = np.sum(x * y, axis=-1)
    den = np.sqrt(np.sum(x * x, axis=-1) * np.sum(y * y, axis=-1))
    c = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    return c.astype("float32")


def max_frequency_gradient_idx(window, n_bins: int, decim: int):
    """The gradient demod of ``[..., sps]`` windows: the bin of the largest
    negative step between adjacent bin averages of the ifreq (threshold
    0.1, the scan from bin 1 storing ``i + 1``, ``(n_bins - max_index) %
    n_bins``), the last bin's average without its final ``max(decim // 2,
    2)`` samples (none at ``decim <= 2``). int32."""
    ifr = instantaneous_frequency(window)
    use = ifr[..., :n_bins * decim].reshape(ifr.shape[:-1] + (n_bins, decim))
    sums = use.sum(axis=-1)
    trim = max(decim // 2, 2) if decim > 2 else 0
    if trim:
        tail = use[..., -1, decim - trim:].sum(axis=-1)
        last = (sums[..., -1] - tail) / (decim - trim)
        avg = np.concatenate([sums[..., :-1] / decim, last[..., None]], axis=-1)
    else:
        avg = sums / decim
    grad = avg[..., :-1] - avg[..., 1:]
    best = np.argmax(grad, axis=-1)
    found = np.take_along_axis(grad, best[..., None], axis=-1)[..., 0] > 0.1
    max_index = np.where(found, best + 2, 0)
    return ((n_bins - max_index) % n_bins).astype("int32")


def fine_sync_lag(window, bin_idx, upchirp_ifreq_tiled, sps: int, decim: int,
                  search_space: int):
    """Clock-drift lag search (reference ``fine_sync`` :300-338): ``-lag``
    (int32) for the lag in ``(-search_space, search_space)`` maximising
    the ifreq dot product with the tiled ideal upchirp at ``(bin +
    1)*decim + sps + lag``; 0 when no correlation is positive."""
    ifr = instantaneous_frequency(window)
    lags = np.arange(-search_space + 1, search_space)
    base = (np.asarray(bin_idx) + 1) * decim + sps
    offs = lags[:, None] + np.arange(sps)[None, :]
    idx = np.asarray(base)[..., None, None] + offs
    refs = np.take(upchirp_ifreq_tiled, idx, axis=-1)
    corr = np.einsum("...s,...ls->...l", ifr, refs)
    best = np.argmax(corr, axis=-1)
    pos = np.take_along_axis(corr, best[..., None], axis=-1)[..., 0] > 0.0
    lag = np.where(pos, lags[best], 0)
    return (-lag).astype("int32")
