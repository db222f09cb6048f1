"""Dense detection frontend: preamble metrics for every window at once.

The reference evaluates ``detect_preamble_autocorr`` one window at a time
in its DETECT state (lib/decoder_impl.cc:340-366,752-768). Here the
metric is computed for every symbol-stride window of a block in one
batched pass. :func:`detection_metrics_planes` is the plain torch version
of the hand-written detection kernel
(:func:`lora_tpu_torch.ops.cuda_kernels.detection_metrics_kernel`): the
CPU path and the yardstick the kernel is held to on the card.
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
