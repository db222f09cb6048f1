"""The state carried into the port: a receiver's host-built tables.

The receiver has no weights. What a :class:`~lora_tpu_torch.rx.dense.
DenseReceiver` holds besides its config is the set of tables it builds on
the host (chirps, ifreq references, fold-DFT matrices, likeness rows,
deinterleave gather tables, payload decode table). :func:`load_tables`
installs such a set, as numpy arrays, on a receiver's device: the
receiver's own (:func:`~lora_tpu_torch.rx.dense.build_tables`), or one
taken from another implementation of the same receiver, so that the
port's arithmetic can be checked apart from its table building.
:func:`load_channelizer` does the same for a polyphase channelizer's
branch taps and DFT planes, and :func:`load_plan_tables` for a plan
gateway's channel taps, folded FIR matrix and output ramp factors.
"""

from __future__ import annotations

import numpy as np
import torch

TABLE_KEYS = ("up", "down", "up_ifreq", "down_ifreq", "up_ifreq_v",
              "fold_mat", "fold_up", "likeness_rows", "deint_tables", "pay_lut")
# the tables a receiver leaves out above the fold budget (sps * n_bins >
# 16M entries): ``None`` in place of the arrays
OPTIONAL_KEYS = ("fold_mat", "fold_up", "likeness_rows")


def _expected_shapes(rx) -> dict:
    from .rx.dense import codeword_capacity

    sps, nb = rx.sps, rx.n_bins
    cw = codeword_capacity(rx.cfg, rx.S)
    return dict(
        up=[(sps,)], down=[(sps,)], up_ifreq=[(sps,)], down_ifreq=[(sps,)],
        up_ifreq_v=[(4 * sps,)],
        fold_mat=[(sps, nb), (sps, nb)], fold_up=[(sps, nb), (sps, nb)],
        likeness_rows=[(nb, sps - 1), (nb,)],
        deint_tables=[(4, cw, 8)] * 3,
        pay_lut=[(2, cw, 256)],
    )


def load_tables(rx, tables: dict) -> None:
    """Install ``tables`` (numpy arrays, tuples of arrays for the
    multi-part tables; ``None`` for a table of ``OPTIONAL_KEYS``, which the
    receiver then does without) on ``rx``'s device. Raises ``KeyError``
    for a missing table and ``ValueError`` for a shape that does not fit
    the receiver's geometry."""
    shapes = _expected_shapes(rx)
    dev = rx.device
    out = {}
    for key in TABLE_KEYS:
        val = tables[key]
        if val is None and key in OPTIONAL_KEYS:
            out[key] = None
            continue
        parts = list(val) if isinstance(val, (tuple, list)) else [val]
        got = [tuple(np.shape(p)) for p in parts]
        if got != shapes[key]:
            raise ValueError(f"table {key!r}: shapes {got}, expected {shapes[key]}")
        tens = tuple(torch.as_tensor(np.ascontiguousarray(p), device=dev)
                     for p in parts)
        out[key] = tens if isinstance(val, (tuple, list)) else tens[0]
    rx._up, rx._down = out["up"], out["down"]
    rx._up_ifreq, rx._down_ifreq = out["up_ifreq"], out["down_ifreq"]
    rx._up_ifreq_v = out["up_ifreq_v"]
    rx._fold_mat, rx._fold_up = out["fold_mat"], out["fold_up"]
    rx._likeness_rows = out["likeness_rows"]
    rx._deint_tables = out["deint_tables"]
    rx._pay_lut = out["pay_lut"]


def load_channelizer(pfb, h_poly, dft=None) -> None:
    """Install the branch taps ``h_poly`` ``[K, M]`` and, optionally, the
    DFT planes ``dft = (cos, sin)`` ``[M, M]`` (numpy) on the
    :class:`~lora_tpu_torch.channelizer.PolyphaseChannelizer` ``pfb``, on
    its device; the device tables built from them are rebuilt at next use.
    Raises ``ValueError`` for a shape that does not fit ``pfb``."""
    want = (pfb.K, pfb.M)
    if tuple(np.shape(h_poly)) != want:
        raise ValueError(f"h_poly: shape {tuple(np.shape(h_poly))}, expected {want}")
    if dft is not None:
        got = [tuple(np.shape(p)) for p in dft]
        if got != [(pfb.M, pfb.M)] * 2:
            raise ValueError(f"dft: shapes {got}, expected {[(pfb.M, pfb.M)] * 2}")
        dft = tuple(np.asarray(p, np.float64) for p in dft)
    pfb._set_taps(np.asarray(h_poly, np.float32))
    pfb._dft_src = dft


def load_plan_tables(gw, taps, g2, ramp=None, length=None) -> None:
    """Install a :class:`~lora_tpu_torch.plans.PlanGateway`'s channel taps
    ``[Nt]`` and folded FIR matrix ``g2`` ``[2C, K*2D]`` (numpy) on its
    device, and optionally the ramp factors ``ramp = (o_re, o_im, i_re,
    i_im)`` for blocks of ``length`` wideband samples (``[C, nb]`` x2 and
    ``[C, tile]`` x2, ``nb = ceil(n_out / tile)``, tile the gateway's).
    The CUDA kernel's tables (``_mix``: the zero-padded taps and the phase
    table) are rebuilt from the installed taps. Raises ``ValueError`` for a
    shape that does not fit the gateway's ``(C, D, K)``."""
    from .channelizer import fused_mix_tables, fused_out_len

    C, D = len(gw.channels), gw.decim
    taps = np.asarray(taps, np.float32)
    K = -(-len(gw.taps) // D)
    if taps.ndim != 1 or len(taps) < 1 or -(-len(taps) // D) != K:
        raise ValueError(f"taps: shape {taps.shape}, expected [Nt] with ceil(Nt / {D}) = {K}")
    if tuple(np.shape(g2)) != (2 * C, K * 2 * D):
        raise ValueError(f"g2: shape {tuple(np.shape(g2))}, expected {(2 * C, K * 2 * D)}")
    if ramp is not None:
        if length is None:
            raise ValueError("ramp factors need the block length they were built for")
        tile = gw._fused_tile
        nb = -(-fused_out_len(length, len(taps), D) // tile)
        want = [(C, nb)] * 2 + [(C, tile)] * 2
        got = [tuple(np.shape(r)) for r in ramp]
        if got != want:
            raise ValueError(f"ramp: shapes {got}, expected {want}")
    gw.taps = taps
    gw._g2 = torch.as_tensor(np.ascontiguousarray(g2, np.float32), device=gw.device)
    gw._mix = tuple(torch.as_tensor(t, device=gw.device)
                    for t in fused_mix_tables(gw.offsets, gw.samp_rate, taps, D))
    gw._tables = {}
    if ramp is not None:
        gw._cached(("fused", int(length)),
                   lambda: tuple(np.ascontiguousarray(r, np.float32) for r in ramp))
