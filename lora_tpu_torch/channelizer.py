"""Polyphase filterbank channelizer: wideband IQ -> per-channel planes.

A critically-sampled ``M``-branch polyphase filterbank splits a wideband
stream at ``samp_rate`` into ``M`` uniformly spaced channels (spacing and
per-channel rate ``samp_rate / M``). Channel ``c`` sits at ``c *
samp_rate / M``, wrapping to negative frequencies for ``c >= M/2`` (the
FFT bin convention, :func:`pfb_channel_freqs`).

Two stages. The branch FIR ``out[p, t, m] = sum_j h[j, m] x[p, t+j, m]``
over the planes ``[2, L]`` viewed as ``[2, n_vec, M]`` is the hand-written
kernel ``csrc/pfb_fir.cu`` on the card
(:func:`lora_tpu_torch.ops.cuda_kernels.pfb_fir_kernel`) and its plain
version :func:`pfb_fir_planes` on the CPU. The M-point DFT across the
branches is one stacked real matrix product (or two, for the two-stage
split), written channel-major so no transpose pass follows.

Filter design follows GNU Radio's ``firdes.low_pass`` (Hamming window,
tap count from the 53 dB attenuation rule), the reference channelizer's
spec. Host constants are built in float64 and cast once.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import full_f32_matmul, resolve_device


def firdes_low_pass(gain: float, samp_rate: float, cutoff: float,
                    transition_width: float) -> np.ndarray:
    """GNU Radio ``firdes.low_pass`` with WIN_HAMMING (the reference's
    channelizer filter, lib/channelizer_impl.cc:46).

    ntaps = 53 dB / (22 * normalized transition width), forced odd; taps
    are a Hamming-windowed sinc normalized to unit DC gain. float32.
    """
    att = 53.0  # Hamming max attenuation, gr::fft::window::max_attenuation
    ntaps = int(att / (22.0 * (transition_width / samp_rate)))
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * (n + m) / (ntaps - 1))
    fwT0 = 2.0 * np.pi * cutoff / samp_rate
    n_safe = np.where(n == 0, 1.0, n)
    taps = np.where(n == 0, fwT0 / np.pi, np.sin(n_safe * fwT0) / (n_safe * np.pi)) * win
    taps = taps * (gain / np.sum(taps))  # unity gain at DC
    return taps.astype(np.float32)


def lora_channel_taps(samp_rate: float, bandwidth: float) -> np.ndarray:
    """The reference's exact channel filter spec (lib/channelizer_impl.cc:46)."""
    return firdes_low_pass(1.0, samp_rate, bandwidth / 2.0 + 15000.0, 10000.0)


def pfb_channel_freqs(samp_rate: float, num_channels: int) -> np.ndarray:
    """Center frequency (Hz, relative to capture center) of each PFB channel."""
    c = np.arange(num_channels)
    f = c * samp_rate / num_channels
    f[f >= samp_rate / 2] -= samp_rate
    return f


def pfb_fir_planes(xf: torch.Tensor, h_poly: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the polyphase branch FIR.

    ``xf``: packed wideband planes ``[2, L]`` (float32 or bfloat16),
    viewed as ``[2, n_vec, M]`` with ``n_vec = L // M`` (a tail of fewer
    than ``M`` samples is ignored); ``h_poly``: float32 taps ``[K, M]``.
    Returns ``[2, n_out, M]`` in ``out_dtype``, ``n_out = n_vec - K + 1``:
    the float32 sum over ``j = 0 .. K-1`` in that order of ``h[j] *
    x[:, j:j+n_out]``, cast once.
    """
    K, M = h_poly.shape
    n_vec = xf.shape[-1] // M
    x3 = xf[..., : n_vec * M].reshape(2, n_vec, M)
    n_out = n_vec - K + 1
    acc = torch.zeros((2, n_out, M), dtype=torch.float32, device=xf.device)
    for j in range(K):
        acc = acc + h_poly[j][None, None, :] * x3[:, j:j + n_out]
    return acc.to(out_dtype)


def _pitch(n: int) -> int:
    """``n`` rounded up to a multiple of 8 elements."""
    return -(-n // 8) * 8


def _dft_np(n: int):
    """``exp(-2j pi r c / n)`` as float64 ``(cos, sin)`` ``[n, n]``; the
    product index is wrapped mod ``n`` so the argument stays small."""
    c = np.arange(n, dtype=np.float64)
    ph = -2.0 * np.pi * ((np.outer(c, c) % n) / n)
    return np.cos(ph), np.sin(ph)


def _stacked(cos, sin) -> np.ndarray:
    """The real form ``[2N, 2N]`` of the complex matrix ``cos + 1j*sin``:
    row ``2r + q`` gives part ``q`` (0 real, 1 imag) of output ``r``;
    column ``p*N + n`` reads part ``p`` of input ``n``."""
    N = cos.shape[0]
    w = np.empty((N, 2, 2, N), cos.dtype)
    w[:, 0, 0], w[:, 0, 1] = cos, -sin
    w[:, 1, 0], w[:, 1, 1] = sin, cos
    return w.reshape(2 * N, 2 * N)


class PolyphaseChannelizer:
    """Critically-sampled polyphase filterbank channelizer.

    The filter work is ``K = ceil(ntaps / M)`` real multiplies per input
    sample regardless of ``M``; the branch recombination is an ``M``-point
    DFT per output vector. ``device``: where the taps and DFT tables live
    (``None`` is the card). ``h_poly`` is the host float32 ``[K, M]``
    polyphase decomposition ``h_poly[j, p] = taps[j*M + p]``.
    """

    def __init__(self, num_channels: int, taps: np.ndarray, device=None):
        self.M = int(num_channels)
        ntaps = len(taps)
        self.K = -(-ntaps // self.M)
        padded = np.zeros(self.K * self.M, dtype=np.float32)
        padded[:ntaps] = taps
        self.device = resolve_device(device)
        self._dft_src = None      # (cos, sin) [M, M] installed from outside
        self._set_taps(padded.reshape(self.K, self.M))

    def _set_taps(self, h_poly: np.ndarray) -> None:
        self.h_poly = h_poly
        self._h = torch.as_tensor(np.ascontiguousarray(h_poly, np.float32),
                                  device=self.device)
        self._cache = {}          # (kind, dtype) -> device tables

    @classmethod
    def for_lora(cls, samp_rate: float, num_channels: int,
                 bandwidth: float = 125e3, device=None):
        """Prototype filter per the reference channel spec, with the
        transition width scaled to the channel spacing: cutoff ``bw/2 +
        15k``, transition ``max(10k, spacing/4)``."""
        spacing = samp_rate / num_channels
        taps = firdes_low_pass(1.0, samp_rate, bandwidth / 2.0 + 15000.0,
                               max(10000.0, spacing / 4.0))
        return cls(num_channels, taps, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Complex path: ``x`` complex ``[n]`` -> ``[M, n//M - K + 1]``
        complex64 channel streams (FIR in complex64, then ``torch.fft``)."""
        M, K = self.M, self.K
        x = x.to(device=self.device, dtype=torch.complex64)
        n_vec = x.shape[-1] // M
        xm = x[: n_vec * M].reshape(n_vec, M)
        n_out = n_vec - K + 1
        filtered = torch.zeros((n_out, M), dtype=torch.complex64, device=self.device)
        for j in range(K):
            filtered = filtered + self._h[j][None, :] * xm[j:j + n_out]
        chans = torch.fft.fft(filtered, dim=-1)
        return chans.transpose(0, 1).contiguous()

    # -- host builders (float64, cast once) ------------------------------
    def _dft_planes(self):
        """``(cos, sin)`` of ``exp(-2j pi c m / M)``, float64 ``[M, M]``
        (or the planes installed by :func:`~lora_tpu_torch.convert.
        load_channelizer`)."""
        return self._dft_src if self._dft_src is not None else _dft_np(self.M)

    def _dft2_planes(self, M1: int, M2: int):
        """Two-stage (Cooley-Tukey) DFT constants, float64: ``(D1 [M1, M1],
        twiddle [M1, M2], D2 [M2, M2])``, each a ``(cos, sin)`` pair."""
        k1 = np.arange(M1, dtype=np.float64)[:, None]
        n2 = np.arange(M2, dtype=np.float64)[None, :]
        ph = -2.0 * np.pi * ((k1 * n2) % self.M) / self.M
        return _dft_np(M1), (np.cos(ph), np.sin(ph)), _dft_np(M2)

    @staticmethod
    def _two_stage_split(M: int, cap: int):
        """Largest factor pair ``M1 * M2 = M`` with both ``<= cap`` and both
        ``>= 8``, ``M1 >= M2``; ``None`` if ``M`` does not factor so."""
        best = None
        for M2 in range(8, int(np.sqrt(M)) + 1):
            if M % M2 == 0 and M2 <= cap and M // M2 <= cap:
                best = (M // M2, M2)
        return best

    def _dev(self, host, dtype) -> torch.Tensor:
        """A float64 host table on the device: cast to float32, then to
        ``dtype`` (float32 -> bfloat16 rounds to nearest even)."""
        host = np.asarray(host, np.float64).astype(np.float32)
        return torch.as_tensor(host, device=self.device).to(dtype)

    def _dft_table(self, dtype) -> torch.Tensor:
        """The stacked single-stage DFT table ``[2M, 2M]`` in ``dtype``."""
        if ("dft", dtype) not in self._cache:
            self._cache["dft", dtype] = self._dev(_stacked(*self._dft_planes()), dtype)
        return self._cache["dft", dtype]

    def _dft2_tables(self, M1: int, M2: int, dtype):
        """Two-stage tables: the stacked inner DFT ``[2M1, 2M1]`` and the
        twiddle planes ``[M1, M2]``, rounded to ``dtype`` and held in
        float32, and the stacked outer DFT ``[2M2, 2M2]`` in ``dtype``."""
        key = ("dft2", M1, M2, dtype)
        if key not in self._cache:
            d1, tw, d2 = self._dft2_planes(M1, M2)
            self._cache[key] = (self._dev(_stacked(*d1), dtype).float(),
                                self._dev(tw[0], dtype).float(),
                                self._dev(tw[1], dtype).float(),
                                self._dev(_stacked(*d2), dtype))
        return self._cache[key]

    # -- packed-plane path -----------------------------------------------
    def planes(self, xf: torch.Tensor, out_dtype=torch.float32,
               max_dft_matmul: int = 2048) -> torch.Tensor:
        """Packed wideband planes ``[2, L]`` -> channel planes ``[M, 2,
        n_out]`` in ``out_dtype`` (float32 or bfloat16).

        FIR: :func:`~lora_tpu_torch.ops.cuda_kernels.pfb_fir_kernel` (the
        kernel on the card, :func:`pfb_fir_planes` on the CPU), in the
        working dtype. Recombination: for ``M <= max_dft_matmul`` one
        product of the stacked ``[2M, 2M]`` DFT table with the filtered
        rows ``[n_out, 2M]``, whose ``[2M, n_out]`` result already is the
        channel-major ``[M, 2, n_out]``; the sum runs in float32 and is
        rounded to the output dtype once (bf16 products are exact in
        float32); that result is a view whose rows have an aligned pitch
        (not contiguous). Above the cap, a two-stage Cooley-Tukey split of
        two small products and a twiddle pass, else a batched FFT.
        """
        from .ops.cuda_kernels import pfb_fir_kernel

        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"channel planes are float32 or bfloat16, not {out_dtype}")
        M, K = self.M, self.K
        n_out = xf.shape[-1] // M - K + 1
        # the filtered rows [fr | fi] are padded to a multiple of 8 rows
        # (zeros): the DFT product's output rows are then 16-byte aligned
        # and of an aligned length, which the card's tensor-core GEMMs need
        # (an odd n_out drops bf16 to an unvectorised kernel)
        n_pad = max(_pitch(n_out), 0)
        buf = torch.empty((n_pad, 2, M), dtype=out_dtype, device=xf.device)
        buf[n_out:].zero_()
        with full_f32_matmul():
            pfb_fir_kernel(xf, self._h, out_dtype, out=buf)   # rows [:n_out]
            rows = buf.view(n_pad, 2 * M)
            if M <= max_dft_matmul:
                out = self._dft_table(out_dtype) @ rows.T     # [2M, n_pad]
                return out.view(M, 2, n_pad)[..., :n_out]
            split = self._two_stage_split(M, max_dft_matmul)
            if split is not None:
                return self._two_stage(rows, n_out, split, out_dtype)
            rows = rows[:n_out]
            x = torch.complex(rows[:, :M].float(), rows[:, M:].float())
            chans = torch.fft.fft(x, dim=-1).transpose(0, 1)
            return torch.stack([chans.real, chans.imag], dim=1).to(out_dtype)

    def _two_stage(self, rows: torch.Tensor, n_out: int, split, dtype) -> torch.Tensor:
        """Cooley-Tukey two-stage DFT of the (padded) filtered rows ``[R,
        2M]``, the first ``n_out`` real: ``n = M2*n1 + n2``, ``k = M1*k2 +
        k1``. The inner ``M1``-DFT over ``n1`` runs in float32 (bf16
        operands upcast: their products are exact), the twiddle
        ``W_M^(k1*n2)`` in float32, rounded to ``dtype`` once, and the
        outer ``M2``-DFT over ``n2`` sums in float32 and rounds once."""
        M1, M2 = split
        R = rows.shape[0]
        w1, twr, twi, w2 = self._dft2_tables(M1, M2, dtype)
        # [R, 2 (p), M1 (n1), M2 (n2)] -> inner DFT, batched over rows o:
        # a[o, 2*k1 + q, n2]
        a = w1 @ rows.float().view(R, 2 * M1, M2)
        a = a.view(R, M1, 2, M2)
        ar, ai = a[:, :, 0], a[:, :, 1]                      # [R, M1, M2]
        # twiddle, written as [M1 (k1), 2 (p), M2 (n2), R] for the outer
        # DFT, batched over k1
        b = torch.empty((M1, 2, M2, R), dtype=dtype, device=rows.device)
        b[:, 0] = (ar * twr - ai * twi).permute(1, 2, 0)
        b[:, 1] = (ar * twi + ai * twr).permute(1, 2, 0)
        out = w2 @ b.view(M1, 2 * M2, R)                     # [k1, (k2, q), o]
        out = out.view(M1, M2, 2, R)[..., :n_out]
        return out.transpose(0, 1).reshape(self.M, 2, n_out)
