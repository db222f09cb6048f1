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

The LoRaWAN plan gateway needs channels on an arbitrary raster (200 kHz
apart), which no critically-sampled PFB grid hosts. Its channelizer is a
batched frequency-translating FIR decimator, ``out_c[n] = sum_k taps[k]
* x[nD + k] * exp(-2j pi a_c (nD + k))`` with ``a_c = f_c / fs``, in two
forms: the fused mix + FIR + decimate (the hand-written kernel
``csrc/fused_chan.cu`` on the card,
:func:`lora_tpu_torch.ops.cuda_kernels.fused_channelize_kernel`, and its
plain version :func:`fused_channelize_planes`), and the factored path
(:func:`channelize_list_planes_factored`: the mixer rebuilt from two
small tables, then :func:`_decimating_fir`), the A/B control.

A handful of channels at arbitrary offsets, the receiver facade's case,
take the plain single-channel pieces: :func:`freq_xlating_fir` (the
reference channelizer's one ``freq_xlating_fir_filter_ccf``) and
:func:`channelize_list` / :func:`channelize_list_planes` (every listed
channel), each a mix by a host-built table (:func:`make_mixer_planes`,
the phase in float64, mod 1) and a real-tap FIR of each plane, one torch
``conv1d`` or product (JAX computes these outside any kernel too).
:func:`fractional_resampler` is the reference's arbitrary-ratio
resampler, host numpy.

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


# -- a few channels at any offsets: the facade's channelizer --------------
def make_mixer_planes(offsets_hz, samp_rate: float, length: int,
                      chunk: int = 1 << 20, start: int = 0) -> np.ndarray:
    """The mixer table ``exp(-2j pi f_c/fs n)`` of every channel, for ``n``
    in ``[start, start + length)``, as float32 planes ``[C, 2, length]``:
    the phase accumulated in float64 and reduced mod 1 cycle before the
    cast (a float32 ramp loses degrees by a few million samples, a spur the
    channel filter cannot remove), built ``chunk`` samples at a time so the
    float64 intermediate stays bounded."""
    offs = np.asarray(offsets_hz, dtype=np.float64) / samp_rate
    C = len(offs)
    out = np.empty((C, 2, length), dtype=np.float32)
    for s in range(0, length, chunk):
        n = start + np.arange(s, min(s + chunk, length), dtype=np.float64)
        ph = -2.0 * np.pi * ((offs[:, None] * n[None, :]) % 1.0)
        out[:, 0, s:s + len(n)] = np.cos(ph)
        out[:, 1, s:s + len(n)] = np.sin(ph)
    return out


def make_mixer_table(offsets_hz, samp_rate: float, length: int) -> np.ndarray:
    """:func:`make_mixer_planes` as complex64 ``[C, length]``."""
    planes = make_mixer_planes(offsets_hz, samp_rate, length)
    return (planes[:, 0] + 1j * planes[:, 1]).astype(np.complex64)


def _iq_planes(x, device) -> torch.Tensor:
    """Float32 planes ``[..., 2, L]``: host complex IQ is moved to
    ``device`` (``None``: the card) and split there; a complex tensor is
    split where it lies; a real tensor is taken as planes."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return torch.stack([x.real, x.imag], dim=-2).to(torch.float32)
        return x.to(torch.float32)
    from .ops.xfer import pack_iq

    return pack_iq(np.asarray(x, dtype=np.complex64), device=resolve_device(device))


def _mix(xf: torch.Tensor, mixer: torch.Tensor) -> torch.Tensor:
    """Complex product of planes ``[2, L]`` and mixer planes ``[..., 2, L]``."""
    xr, xi = xf[0], xf[1]
    mr, mi = mixer[..., 0, :], mixer[..., 1, :]
    return torch.stack([mr * xr - mi * xi, mr * xi + mi * xr], dim=-2)


def freq_xlating_fir(x, taps, center_offset: float, samp_rate: float,
                     decimation: int, device=None) -> torch.Tensor:
    """Single-channel frequency-translating FIR decimator, the reference's
    ``freq_xlating_fir_filter_ccf(decimation, taps, offset, samp_rate)``:
    mix ``x`` (host complex ``[L]``, or a tensor of complex or planes) down
    by ``center_offset`` Hz, low-pass, keep every ``decimation``-th sample.
    ``out[n] = sum_k taps[k] * mixed[n*D + k]``, ``(L - Nt) // D + 1``
    outputs (the valid convolution with the reversed taps). complex64
    ``[m]`` on ``x``'s device (host input: ``device``, ``None`` the card).
    An offset of 0 mixes by exactly 1 and is skipped."""
    xf = _iq_planes(x, device)
    if center_offset != 0:
        mixer = torch.as_tensor(make_mixer_planes([center_offset], samp_rate, xf.shape[-1])[0],
                                device=xf.device)
        xf = _mix(xf, mixer)
    y = _decimating_fir(xf, taps, decimation)
    return torch.complex(y[0], y[1])


def channelize_list_planes(xf: torch.Tensor, taps, mixer_planes,
                           decimation: int) -> torch.Tensor:
    """Every channel of a list at once: packed planes ``[2, L]`` float32,
    the mixer planes ``[C, 2, L]`` (numpy or a tensor; see
    :func:`make_mixer_planes`) -> channel planes ``[C, 2, m]`` float32,
    each mixed plane filtered by the real taps and decimated
    (:func:`_decimating_fir`)."""
    mixer = torch.as_tensor(mixer_planes, dtype=torch.float32, device=xf.device)
    return _decimating_fir(_mix(xf, mixer), taps, decimation)


def channelize_list(x, taps, offsets_hz, samp_rate: float, decimation: int,
                    mixers=None, device=None) -> torch.Tensor:
    """Batched frequency-translating FIR over a list of channel offsets:
    ``x`` (host complex ``[L]`` or a tensor) -> complex64 ``[C, m]`` on
    ``x``'s device (host input: ``device``, ``None`` the card). Its cost
    grows with the channel count: a dense grid wants the polyphase
    channelizer. ``mixers``: an optional precomputed complex ``[C, L]``
    table; by default the host builds it in float64
    (:func:`make_mixer_planes`), where JAX's default ramps the phase in
    float32 on the device, which its own note says degrades past ~100k
    samples."""
    xf = _iq_planes(x, device)
    L = xf.shape[-1]
    if mixers is None:
        mp = make_mixer_planes(offsets_hz, samp_rate, L)
    else:
        m = np.asarray(mixers.cpu() if isinstance(mixers, torch.Tensor) else mixers,
                       np.complex64)
        mp = np.stack([m.real, m.imag], axis=1)
    y = channelize_list_planes(xf, taps, mp, decimation)
    return torch.complex(y[:, 0], y[:, 1])


def fractional_resampler(x, ratio: float, ntaps: int = 8,
                         nphases: int = 128) -> np.ndarray:
    """Arbitrary-ratio resampler (reference ``fractional_resampler_cc``,
    python/lora_receiver.py:60, GNU Radio's MMSE 8-tap interpolating FIR):
    ``out[n] = x(n * ratio)`` through a bank of ``nphases`` Hamming-windowed
    sinc filters of ``ntaps`` taps, the phase chosen by the fractional
    sample position; ``ratio > 1`` decimates. Host numpy: capture
    pre-conditioning, off the card's path."""
    x = np.asarray(x)
    half = ntaps // 2
    phases = np.arange(nphases) / nphases
    k = np.arange(-half + 1, half + 1, dtype=np.float64)  # ntaps offsets
    t = k[None, :] - phases[:, None]                       # [nphases, ntaps]
    sinc = np.sinc(t)
    win = 0.54 + 0.46 * np.cos(np.pi * t / half)
    bank = (sinc * win).astype(np.float64)
    bank /= bank.sum(axis=1, keepdims=True)                # unit DC gain

    n_out = int((len(x) - ntaps) / ratio)
    pos = np.arange(n_out) * ratio
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    phase = np.minimum((frac * nphases + 0.5).astype(np.int64), nphases - 1)
    idx = base[:, None] + k[None, :].astype(np.int64)      # [n_out, ntaps]
    idx = np.clip(idx, 0, len(x) - 1)
    out = np.sum(x[idx] * bank[phase], axis=1)
    return out.astype(x.dtype)


# -- the plan channelizer: host tables (numpy, float64, cast once) --------
def make_mixer_factors(offsets_hz, samp_rate: float, length: int,
                       tile: int = 4096):
    """Rank-1 factorisation of the mixer table ``exp(-2j pi a_c n)``,
    ``a_c = f_c / fs``: over ``n = i*tile + j`` it is the product of an
    outer block phasor ``exp(-2j pi frac(a_c tile i))`` ``[C, nI]`` and an
    inner ramp ``exp(-2j pi frac(a_c j))`` ``[C, tile]``, both phase-reduced
    in float64 on the host, so the product's phase error stays at float32
    rounding for any ``n`` (a float32 ramp on the device drifts by degrees
    over millions of samples). Returns ``(outer, inner)`` packed float32
    planes ``[C, 2, nI]`` / ``[C, 2, tile]``, ``nI = ceil(length / tile)``.
    """
    offs = np.asarray(offsets_hz, dtype=np.float64) / samp_rate
    nI = -(-int(length) // tile)
    ph_o = -2.0 * np.pi * (
        (offs[:, None] * tile * np.arange(nI, dtype=np.float64)[None, :]) % 1.0
    )
    ph_i = -2.0 * np.pi * (
        (offs[:, None] * np.arange(tile, dtype=np.float64)[None, :]) % 1.0
    )
    outer = np.stack([np.cos(ph_o), np.sin(ph_o)], axis=1).astype(np.float32)
    inner = np.stack([np.cos(ph_i), np.sin(ph_i)], axis=1).astype(np.float32)
    return outer, inner


def make_fused_fir_matrix(offsets_hz, samp_rate: float, taps,
                          decimation: int) -> np.ndarray:
    """Folded FIR matrix of the fused channelizer, ``[2C, K*2D]`` float32.

    The decimated frequency-translating FIR splits over ``k = j*D + d``
    into a per-output ramp ``exp(-2j pi a_c D n)`` (applied after the sum,
    :func:`make_output_ramp_factors`) and a contraction with ``g_c[d, j] =
    taps[j*D + d] * exp(-2j pi a_c d) * exp(-2j pi a_c D j)``, all phases
    reduced in float64. Rows ``0..C-1`` give the real output planes,
    ``C..2C-1`` the imaginary ones; feature ``f = j*2D + p*D + d``
    multiplies input plane ``p``'s sample ``(n + j)*D + d``. ``K =
    ceil(len(taps) / D)``; the taps are zero-padded to ``K*D``.
    """
    a = np.asarray(offsets_hz, np.float64) / samp_rate
    D = int(decimation)
    taps = np.asarray(taps, np.float64)
    Nt = len(taps)
    K = -(-Nt // D)
    tpad = np.zeros(K * D, np.float64)
    tpad[:Nt] = taps
    h = tpad.reshape(K, D)                                   # h[j, d]
    C = len(a)
    ph_d = -2.0 * np.pi * ((a[:, None] * np.arange(D)) % 1.0)
    ph_j = -2.0 * np.pi * ((a[:, None] * D * np.arange(K)) % 1.0)
    g = (h.T[None, :, :]
         * np.exp(1j * ph_d)[:, :, None]
         * np.exp(1j * ph_j)[:, None, :])                    # [C, D, K]
    g_re = np.real(g).transpose(0, 2, 1)                     # [C, K, D]
    g_im = np.imag(g).transpose(0, 2, 1)
    A = np.stack([g_re, -g_im], axis=2)                      # [C, K, 2, D]
    B = np.stack([g_im, g_re], axis=2)
    G2 = np.concatenate([A.reshape(C, -1), B.reshape(C, -1)], axis=0)
    return G2.astype(np.float32)


def make_output_ramp_factors(offsets_hz, samp_rate: float, decimation: int,
                             nb: int, tile: int):
    """The output ramp ``exp(-2j pi a_c D n)`` for ``n = i*tile + l``,
    factored into an outer phasor ``[C, nb]`` and an inner ramp ``[C,
    tile]``: the input-rate mixer of :func:`make_mixer_factors` at ``D``
    times the offset. Returns ``(o_re, o_im, i_re, i_im)`` float32."""
    offs = np.asarray(offsets_hz, np.float64) * decimation
    outer, inner = make_mixer_factors(offs, samp_rate, nb * tile, tile=tile)
    return (outer[:, 0].copy(), outer[:, 1].copy(),
            inner[:, 0].copy(), inner[:, 1].copy())


# -- the plan channelizer: device paths ----------------------------------
def fused_out_len(L: int, n_taps: int, decimation: int) -> int:
    """Output samples of the decimating FIR, ``(L - n_taps) // D + 1``;
    raises ``ValueError`` when the block is shorter than the filter."""
    n_out = (int(L) - int(n_taps)) // int(decimation) + 1
    if n_out < 1:
        raise ValueError(f"a block of {L} samples is shorter than the {n_taps}-tap filter")
    return n_out


def fused_ramp_factors(offsets_hz, samp_rate: float, decimation: int, n_taps: int,
                       length: int, tile: int = 1024):
    """:func:`make_output_ramp_factors` for a block of ``length`` samples:
    ``nb = ceil(n_out / tile)`` tiles of its ``n_out`` outputs."""
    n_out = fused_out_len(length, n_taps, decimation)
    return make_output_ramp_factors(offsets_hz, samp_rate, decimation, -(-n_out // tile), tile)


def fused_mix_tables(offsets_hz, samp_rate: float, taps, decimation: int):
    """The tables of the CUDA kernel's factored form (mix each input sample
    per channel, then apply the real taps): ``(h, phi)`` float32, ``h``
    the taps zero-padded to ``K*D`` (``K = ceil(len(taps) / D)``, the
    layout of :func:`_decimating_fir`'s ``tpad``: ``h[j*D + d]``) and
    ``phi`` ``[C, 2, D]`` the phase table ``exp(-2j pi frac(a_c d))``,
    ``d < D``, reduced in float64 (:func:`make_mixer_factors` over ``D``
    samples in one tile). With the output ramp's inner table ``rho_c[q] =
    exp(-2j pi frac(a_c D q))`` the mixer of sample ``(n0 + q)*D + d`` is
    ``ramp_c(n0) * rho_c[q] * phi_c[d]``."""
    D = int(decimation)
    taps = np.asarray(taps, np.float32)
    K = -(-len(taps) // D)
    h = np.zeros(K * D, np.float32)
    h[:len(taps)] = taps
    return h, make_mixer_factors(offsets_hz, samp_rate, D, tile=D)[1]


def fused_tables(offsets_hz, samp_rate: float, taps, decimation: int, length: int, device,
                 tile: int = 1024):
    """The fused channelizer's tables for blocks of ``length`` samples, as
    float32 tensors on ``device``: ``(g2, ramp, mix)``, the
    :func:`make_fused_fir_matrix` (the plain version's), the
    :func:`fused_ramp_factors` (both's) and the :func:`fused_mix_tables`
    ``(h, phi)`` (the CUDA kernel's)."""
    g2 = torch.as_tensor(make_fused_fir_matrix(offsets_hz, samp_rate, taps, decimation),
                         device=device)
    ramp = tuple(torch.as_tensor(r, device=device) for r in fused_ramp_factors(
        offsets_hz, samp_rate, decimation, len(taps), length, tile))
    mix = tuple(torch.as_tensor(t, device=device)
                for t in fused_mix_tables(offsets_hz, samp_rate, taps, decimation))
    return g2, ramp, mix


def fused_channelize_planes(xf: torch.Tensor, g2: torch.Tensor, ramp, decimation: int,
                            n_taps: int, tile: int) -> torch.Tensor:
    """Plain version of the fused mix + FIR + decimate channelizer.

    ``xf``: packed wideband planes ``[2, L]`` float32; ``g2``: the
    :func:`make_fused_fir_matrix` ``[2C, K*2D]``; ``ramp``: ``(o_re, o_im,
    i_re, i_im)`` of :func:`make_output_ramp_factors` for ``nb =
    ceil(n_out / tile)`` blocks of ``tile`` outputs, all tensors on
    ``xf``'s device. With the planes viewed phase-major (row ``p*D + d``
    holds plane ``p``'s samples ``q*D + d``), ``s = sum_{j<K} g2[:,
    j*2D:(j+1)*2D] @ xp[:, j:j+n_out]`` in full float32; then output ``n``
    of channel ``c`` is ``s_c[n]`` times the complex ramp ``outer[c, n //
    tile] * inner[c, n % tile]``, each complex product in the order
    ``(re*re - im*im, re*im + im*re)``. Returns ``[C, 2, n_out]`` float32,
    ``n_out = (L - n_taps) // D + 1``; samples past ``L`` read as zero.
    Any geometry is taken.
    """
    D = int(decimation)
    twoC, F = g2.shape
    C = twoC // 2
    K = F // (2 * D)
    L = xf.shape[-1]
    n_out = fused_out_len(L, n_taps, D)
    o_re, o_im, i_re, i_im = ramp
    nb = -(-n_out // tile)
    if o_re.shape[-1] != nb or i_re.shape[-1] != tile:
        raise ValueError(f"ramp factors built for nb={o_re.shape[-1]}, tile="
                         f"{i_re.shape[-1]}; this call needs nb={nb}, tile={tile}")
    Q = n_out + K - 1
    xq = torch.nn.functional.pad(xf[:, : Q * D], (0, max(Q * D - L, 0)))
    xp = xq.reshape(2, Q, D).transpose(1, 2).reshape(2 * D, Q)
    with full_f32_matmul():
        s = g2[:, : 2 * D] @ xp[:, :n_out]
        for j in range(1, K):
            s = s + g2[:, j * 2 * D:(j + 1) * 2 * D] @ xp[:, j:j + n_out]
    n = torch.arange(n_out, device=xf.device)
    blk, lane = n // tile, n % tile
    ore, oim = o_re[:, blk], o_im[:, blk]
    ir, ii = i_re[:, lane], i_im[:, lane]
    rr = ore * ir - oim * ii
    ri = ore * ii + oim * ir
    s_re, s_im = s[:C], s[C:]
    return torch.stack([rr * s_re - ri * s_im, ri * s_re + rr * s_im], dim=1)


def channelize_list_planes_factored(xf: torch.Tensor, taps, outer: torch.Tensor,
                                    inner: torch.Tensor, decimation: int) -> torch.Tensor:
    """The factored channelizer: packed planes ``[2, L]`` float32 and the
    :func:`make_mixer_factors` planes ``outer [C, 2, nI]`` / ``inner [C,
    2, tile]`` (tensors on ``xf``'s device) -> ``[C, 2, n_out]`` float32.
    The mixer is rebuilt on the device as the broadcast complex product
    of the two tables, the mixed planes ``[C, 2, L]`` are materialised,
    and :func:`_decimating_fir` filters and decimates them."""
    C, _, nI = outer.shape
    T = inner.shape[-1]
    L = xf.shape[-1]
    xf = torch.nn.functional.pad(xf, (0, nI * T - L))
    xr = xf[0].reshape(nI, T)
    xi = xf[1].reshape(nI, T)
    mr = (outer[:, 0, :, None] * inner[:, 0, None, :]
          - outer[:, 1, :, None] * inner[:, 1, None, :])   # [C, nI, T]
    mi = (outer[:, 0, :, None] * inner[:, 1, None, :]
          + outer[:, 1, :, None] * inner[:, 0, None, :])
    mixed_r = (mr * xr[None] - mi * xi[None]).reshape(C, nI * T)[:, :L]
    mixed_i = (mr * xi[None] + mi * xr[None]).reshape(C, nI * T)[:, :L]
    mixed = torch.stack([mixed_r, mixed_i], dim=1)        # [C, 2, L]
    return _decimating_fir(mixed, taps, decimation)


def _decimating_fir(mixed: torch.Tensor, taps, decimation: int) -> torch.Tensor:
    """Decimating FIR on plane rows ``[..., L]``: ``out[n] = sum_k taps[k]
    * m[n*D + k]`` (the correlation form), ``n < (L - Nt) // D + 1``.

    For ``D >= 2`` and ``K = ceil(Nt / D) <= 64``: the rows viewed as
    ``[Q, D]`` phase rows times the taps arranged ``H[d, j] = taps[j*D +
    d]``, one ``[D x K]`` product (1/D of the full-rate work), then the K
    shifted diagonals summed; zero rows pad the tail, where only the
    zero-padded taps reach. Otherwise one strided ``conv1d``. Both run in
    full float32 (no TF32).
    """
    D = int(decimation)
    taps = np.asarray(taps, np.float32)
    Nt = len(taps)
    L = mixed.shape[-1]
    lead = mixed.shape[:-1]
    K = -(-Nt // D)
    with full_f32_matmul():
        if D < 2 or K > 64:
            t = torch.as_tensor(taps, device=mixed.device).view(1, 1, Nt)
            y = torch.nn.functional.conv1d(mixed.reshape(-1, 1, L), t, stride=D)
            return y.reshape(lead + (-1,))
        tpad = np.zeros(K * D, np.float32)
        tpad[:Nt] = taps
        H = torch.as_tensor(np.ascontiguousarray(tpad.reshape(K, D).T), device=mixed.device)
        n_out = (L - Nt) // D + 1
        Q = n_out + K - 1
        mixed = torch.nn.functional.pad(mixed[..., : Q * D], (0, max(Q * D - L, 0)))
        Z = mixed.reshape(lead + (Q, D)) @ H                 # [..., Q, K]
        out = Z[..., 0:n_out, 0]
        for j in range(1, K):
            out = out + Z[..., j:j + n_out, j]
        return out
