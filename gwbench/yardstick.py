"""Least work of the kernels the benchmark reads, and the card's peaks.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``
:161, ``lag_bound`` :442, ``fused_min_ops`` :538): counted from the
problem's shapes, whatever kernel computes it, so a later kernel that
does the same job reads against the same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: device-memory rate and the float32 rate
# outside the tensor cores, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fused_min_ops(C: int, D: int, n_taps: int, n_out: int) -> int:
    """float32 operations the plan channelizer's function needs at least:
    each channel mixes each input sample once (a complex product, 6 flops;
    ``D`` samples an output), then applies the real taps to the mixed
    samples (a real-by-complex multiply-add, 4 flops a tap and output)."""
    return C * n_out * (6 * D + 4 * n_taps)


def channelizer_bound_s(C: int, D: int, n_taps: int, L: int, n_out: int) -> float:
    """Least seconds of one channelizer call over ``L`` wideband samples:
    the larger of its operations at the float32 peak and its bytes (the
    float32 planes read once, the ``[C, 2, n_out]`` float32 output written
    once) at the memory peak."""
    t_ops = fused_min_ops(C, D, n_taps, n_out) / F32_FLOPS_PER_S
    t_bytes = (2 * L * 4 + C * 2 * n_out * 4) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes)


def lag_bound_s(C: int, L: int, itemsize: int, sps: int, lags) -> float:
    """Least seconds of the multi-lag detection pass over planes ``[C, 2,
    L]``: the planes read once and the ``1 + 2 len(lags)`` rows a channel
    written once, or 4 float32 flops a complex sample for the energy and 8
    for each lag's product where the partner row exists, whichever is
    longer."""
    R = L // sps
    t_bytes = (C * 2 * L * itemsize + C * (1 + 2 * len(lags)) * R * 4) / HBM_BYTES_PER_S
    t_ops = (4 * C * R * sps + sum(8 * C * max(R - m, 0) * sps for m in lags)) \
        / F32_FLOPS_PER_S
    return max(t_bytes, t_ops)
