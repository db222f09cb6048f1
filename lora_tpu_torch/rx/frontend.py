"""Dense detection frontend: preamble metrics for every window at once.

The reference evaluates ``detect_preamble_autocorr`` one window at a time
in its DETECT state (lib/decoder_impl.cc:340-366,752-768). Here the
metric is computed for every symbol-stride window of a block in one
batched pass. :func:`detection_metrics_planes` is the plain torch version
of the hand-written detection kernel
(:func:`lora_tpu_torch.ops.cuda_kernels.detection_metrics_kernel`): the
CPU path and the yardstick the kernel is held to on the card, for both of
its variants (``"pp"`` and the staged ``"tile"`` kernel).
:func:`detection_metrics_wm_planes` is the same metric on window-major
IQ, the plain version of the window-major kernel.
:func:`detection_metrics` takes complex IQ instead of planes (the
complex-input cores of the dense receiver), and
:func:`detection_metrics_dechirp` is the coherent low-SNR metric, one
fold-DFT product over every window (no kernel: JAX computes it outside
any Pallas kernel too).

Several spreading factors share one pass: every SF's symbol is a whole
number of the smallest SF's, so :func:`lag_rows_planes` (the plain
version of the multi-lag kernel
:func:`~lora_tpu_torch.ops.cuda_kernels.lag_rows_kernel`) computes
fine-row energies and lag products once, and
:func:`metrics_from_lag_rows` sums them into each SF's metrics.
"""

from __future__ import annotations

import torch

LEAK_RATIO = 10.0 ** 3.5  # 35 dB: 5 dB guard under the >=40 dB sidelobe
                          # attenuation of the channel filters (53 dB
                          # Hamming designs), so only signals that CANNOT
                          # be genuine in-channel packets are masked


def detection_metrics_planes(xf: torch.Tensor, sps: int):
    """Per-window preamble autocorrelation on packed IQ ``[..., 2, L]``
    (float32 or bfloat16; sums in float32).

    Windows start at ``k*sps`` for ``k = 0 .. K-1``, ``K = L//sps - 1``.
    Returns ``(corr, e1, e2)`` float32 ``[..., K]``: ``|dot_k| /
    sqrt(e_k e_{k+1})`` with ``dot_k = sum_t x_k[t] conj(x_{k+1}[t])``
    (0 where the denominator is 0), and the two windows' total energies.
    """
    L = xf.shape[-1]
    K = L // sps - 1
    lead = xf.shape[:-2]
    xf = xf.to(torch.float32)
    r = xf[..., 0, :(K + 1) * sps].reshape(lead + (K + 1, sps))
    i = xf[..., 1, :(K + 1) * sps].reshape(lead + (K + 1, sps))
    dot_re = (r[..., :-1, :] * r[..., 1:, :] + i[..., :-1, :] * i[..., 1:, :]).sum(-1)
    dot_im = (i[..., :-1, :] * r[..., 1:, :] - r[..., :-1, :] * i[..., 1:, :]).sum(-1)
    eners = (r * r + i * i).sum(-1)   # [..., K+1]
    e1 = eners[..., :K]
    e2 = eners[..., 1:]
    denom = torch.sqrt(e1 * e2)
    mag = torch.sqrt(dot_re * dot_re + dot_im * dot_im)
    ok = denom > 0
    corr = torch.where(ok, mag / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(mag))
    return corr, e1, e2


def detection_metrics(x: torch.Tensor, sps: int):
    """:func:`detection_metrics_planes` on complex IQ ``[..., L]``
    (complex64): the windows' conjugate dots and energies, ``(corr, e1,
    e2)`` float32 ``[..., K]``, ``K = L//sps - 1``."""
    L = x.shape[-1]
    K = L // sps - 1
    lead = x[..., :(K + 1) * sps]
    lag_prod = lead[..., :K * sps] * torch.conj(lead[..., sps:])
    mag2 = lead.real ** 2 + lead.imag ** 2
    dots = lag_prod.reshape(lag_prod.shape[:-1] + (K, sps)).sum(-1)
    eners = mag2.reshape(mag2.shape[:-1] + (K + 1, sps)).sum(-1)
    e1 = eners[..., :K]
    e2 = eners[..., 1:]
    denom = torch.sqrt(e1 * e2)
    ok = denom > 0
    corr = torch.where(ok, dots.abs() / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))
    return corr.to(torch.float32), e1.to(torch.float32), e2.to(torch.float32)


def detection_metrics_dechirp(xf: torch.Tensor, sps: int, fold_mat):
    """Coherent low-SNR preamble detection on packed planes ``[..., 2, L]``.

    Each symbol-stride window is dechirped and folded by one fold-DFT
    product for the whole block (``fold_mat = (Er, Ei)`` ``[sps,
    n_bins]``, :func:`~lora_tpu_torch.ops.demod.make_fold_dft`), a
    ``10*log10(sps)`` processing gain the autocorrelation metric lacks.
    The score of window ``k`` is the smaller of the folded-power
    peak/mean ratios of windows ``k`` and ``k+1``, where their argmax bins
    agree to within one (repeated preamble upchirps fold to one tone;
    noise argmaxes are uniform), else 0. Returns ``(score, e1, e2)``
    float32 ``[..., K]`` with :func:`detection_metrics_planes`'s window
    grid and energies; the noise baseline of the score is ``ln(n_bins) +
    0.577``. Run it under
    :func:`~lora_tpu_torch.device.full_f32_matmul`: TF32 would move the
    scores."""
    er, ei = fold_mat
    n_bins = er.shape[-1]
    L = xf.shape[-1]
    K1 = L // sps
    K = K1 - 1
    xf = xf.to(torch.float32)
    lead = xf.shape[:-2]
    r = xf[..., 0, :K1 * sps].reshape(lead + (K1, sps))
    i = xf[..., 1, :K1 * sps].reshape(lead + (K1, sps))
    fr = r @ er - i @ ei
    fi = r @ ei + i @ er
    p = fr * fr + fi * fi                       # [..., K1, n_bins]
    peak = p.amax(dim=-1)
    mean = p.mean(dim=-1)
    bins = torch.argmax(p, dim=-1)
    ratio = peak / torch.clamp(mean, min=1e-30)
    d = (bins[..., :-1] - bins[..., 1:]) % n_bins
    dist = torch.minimum(d, n_bins - d)
    score = torch.where(dist <= 1, torch.minimum(ratio[..., :-1], ratio[..., 1:]),
                        torch.zeros_like(ratio[..., 1:]))
    e = (r * r + i * i).sum(-1)                 # [..., K1]
    return (score.to(torch.float32), e[..., :K].to(torch.float32),
            e[..., 1:].to(torch.float32))


def detection_metrics_wm_planes(xw: torch.Tensor):
    """Per-window preamble autocorrelation on window-major IQ ``[..., K1,
    2, sps]`` (float32; window ``k`` is ``xw[..., k, :, :]``, its two
    planes side by side).

    Returns ``(corr, ener)`` float32 ``[..., K1]``: ``corr[k] = |dot_k| /
    sqrt(e_k e_n)`` with ``dot_k = sum_t x_k[t] conj(x_n[t])`` and ``n = k
    + 1``, except for the last window, which is paired with itself (so its
    corr is 1 where its energy is > 0); 0 where the denominator is 0.
    ``ener[k]`` is window ``k``'s total energy. The plain version of the
    window-major detection kernel
    (:func:`lora_tpu_torch.ops.cuda_kernels.detection_metrics_wm_kernel`).
    """
    xw = xw.to(torch.float32)
    r = xw[..., 0, :]                                   # [..., K1, sps]
    i = xw[..., 1, :]
    rn = torch.cat([r[..., 1:, :], r[..., -1:, :]], dim=-2)
    i_n = torch.cat([i[..., 1:, :], i[..., -1:, :]], dim=-2)
    dot_re = (r * rn + i * i_n).sum(-1)
    dot_im = (i * rn - r * i_n).sum(-1)
    ener = (r * r + i * i).sum(-1)
    e_n = torch.cat([ener[..., 1:], ener[..., -1:]], dim=-1)
    denom = torch.sqrt(ener * e_n)
    mag = torch.sqrt(dot_re * dot_re + dot_im * dot_im)
    ok = denom > 0
    corr = torch.where(ok, mag / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(mag))
    return corr, ener


def check_lags(lags) -> tuple:
    """Sorted unique lags as ints; ``ValueError`` for none or one below 1."""
    lags = tuple(sorted({int(lag) for lag in lags}))
    if not lags or lags[0] < 1:
        raise ValueError(f"lags must be integers >= 1, got {lags}")
    return lags


def lag_rows_planes(xf: torch.Tensor, sps_min: int, lags):
    """Fine-row energies and lag products of packed IQ ``[..., 2, L]``
    (float32 or bfloat16; sums in float32).

    Row ``r`` is the ``sps_min`` samples from ``r * sps_min``, ``R = L //
    sps_min`` rows. Returns ``(e, {lag: (q_re, q_im)})``, each float32
    ``[..., R]``: ``e[r] = sum_t |x_r[t]|^2`` and ``q[r] = sum_t x_r[t] *
    conj(x_{r+lag}[t])``, zero for ``r >= R - lag`` (so all zeros for a lag
    ``>= R``). An SF whose symbol is ``m`` rows has its adjacent-window dot
    in the sums of ``m`` consecutive ``q_m`` rows."""
    lags = check_lags(lags)
    L = xf.shape[-1]
    R = L // sps_min
    lead = xf.shape[:-2]
    xf = xf.to(torch.float32)
    r = xf[..., 0, :R * sps_min].reshape(lead + (R, sps_min))
    i = xf[..., 1, :R * sps_min].reshape(lead + (R, sps_min))
    e = (r * r + i * i).sum(-1)
    qs = {}
    for lag in lags:
        if lag >= R:
            z = torch.zeros(lead + (R,), dtype=torch.float32, device=xf.device)
            qs[lag] = (z, z)
            continue
        q_re = (r[..., :-lag, :] * r[..., lag:, :] + i[..., :-lag, :] * i[..., lag:, :]).sum(-1)
        q_im = (i[..., :-lag, :] * r[..., lag:, :] - r[..., :-lag, :] * i[..., lag:, :]).sum(-1)
        qs[lag] = (torch.nn.functional.pad(q_re, (0, lag)),
                   torch.nn.functional.pad(q_im, (0, lag)))
    return e, qs


def metrics_from_lag_rows(e: torch.Tensor, q_re: torch.Tensor, q_im: torch.Tensor,
                          m: int):
    """One SF's ``(corr, e1, e2)`` from the fine-row substrate, ``m`` rows
    a symbol: the metrics :func:`detection_metrics_planes` gives at
    ``sps = m * sps_min`` (the same window grid, from sample 0)."""
    R = e.shape[-1]
    Kw = R // m
    K = Kw - 1
    lead = e.shape[:-1]
    if K < 1:
        z = torch.zeros(lead + (0,), dtype=torch.float32, device=e.device)
        return z, z, z
    e_win = e[..., :Kw * m].reshape(lead + (Kw, m)).sum(-1)
    dot_re = q_re[..., :Kw * m].reshape(lead + (Kw, m)).sum(-1)
    dot_im = q_im[..., :Kw * m].reshape(lead + (Kw, m)).sum(-1)
    e1 = e_win[..., :K]
    e2 = e_win[..., 1:K + 1]
    mag = torch.sqrt(dot_re[..., :K] ** 2 + dot_im[..., :K] ** 2)
    denom = torch.sqrt(e1 * e2)
    ok = denom > 0
    corr = torch.where(ok, mag / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(mag))
    return corr.to(torch.float32), e1, e2


def multi_sf_detection_metrics(xf: torch.Tensor, sps_by_sf: dict) -> dict:
    """``{sf: (corr, e1, e2)}`` for every SF of ``sps_by_sf`` (``{sf:
    samples_per_symbol}``) from one pass over packed IQ ``[..., 2, L]``:
    the multi-lag kernel on a CUDA tensor, its plain version on a CPU one.
    Raises ``ValueError`` unless every sps is a whole multiple of the
    smallest."""
    from ..ops.cuda_kernels import lag_rows_kernel

    sps_min = min(sps_by_sf.values())
    if any(sps % sps_min for sps in sps_by_sf.values()):
        raise ValueError("multi-SF metrics need commensurate symbol lengths")
    ms = {sf: sps // sps_min for sf, sps in sps_by_sf.items()}
    e, qs = lag_rows_kernel(xf, sps_min, set(ms.values()))
    return {sf: metrics_from_lag_rows(e, qs[m][0], qs[m][1], m) for sf, m in ms.items()}


def leak_suppression(e1: torch.Tensor) -> torch.Tensor:
    """Cross-channel sidelobe-leak mask for window energies ``[..., K]``
    (leading axes are channel-like): a window whose energy sits
    ``LEAK_RATIO`` below the strongest channel's energy at the same
    window cannot be a genuine in-channel packet. A single stream (no
    leading axes) is never suppressed."""
    if e1.ndim < 2:
        return torch.zeros(e1.shape, dtype=torch.bool, device=e1.device)
    peak = e1.amax(dim=tuple(range(e1.ndim - 1)), keepdim=True)
    return e1 * LEAK_RATIO < peak


def candidate_starts(corr: torch.Tensor, threshold: float, max_candidates: int,
                     suppress=None):
    """Rising-edge packet-start candidates from the dense metric.

    A candidate is the first window of a run of >= 2 consecutive
    ``corr >= threshold`` windows. Returns ``(starts, valid, n_dropped)``:
    the earliest ``max_candidates`` window indices per stream (int32
    ``[..., max_candidates]``), their validity, and the count of rising
    edges past the capacity (int32 ``[...]``).
    """
    hit = corr >= threshold
    false = torch.zeros(hit.shape[:-1] + (1,), dtype=torch.bool, device=hit.device)
    nxt = torch.cat([hit[..., 1:], false], dim=-1)
    prev = torch.cat([false, hit[..., :-1]], dim=-1)
    rising = hit & nxt & ~prev
    if suppress is not None:
        rising = rising & ~suppress
    K = corr.shape[-1]
    ar = torch.arange(K, dtype=torch.int32, device=corr.device)
    idx = torch.where(rising, ar, K)
    # ties are harmless: the sorted values are the indices themselves
    starts = torch.sort(idx, dim=-1).values[..., :max_candidates]
    valid = starts < K
    n_dropped = torch.clamp(
        rising.sum(dim=-1, dtype=torch.int32) - max_candidates, min=0)
    return starts.to(torch.int32), valid, n_dropped.to(torch.int32)
