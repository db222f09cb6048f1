"""The port's polyphase channelizer against lora_tpu's, on the same numpy
inputs, on the CPU.

Held to:
- filter taps, ``h_poly`` and channel frequencies: equal;
- the branch FIR's plain version against the Pallas kernel (interpret
  mode): float32 within ``1e-6 * sum_j |h_j| * max|x|`` (the same sum in
  the same order; the bound covers a reordering), bf16 output within one
  bf16 ulp (at most ``2^-7`` of the value);
- ``planes``, float32: within ``2e-6 * max|want|`` (one stacked product
  sums the real and imaginary halves in another order than JAX's four
  products);
- ``planes``, bfloat16: within one bf16 ulp (``2^-7 |want|``) plus
  ``1e-6 * max|want|`` (float32 sums in another order round to the other
  side of a bf16 tie); the two-stage split rounds an intermediate to bf16
  as JAX does, and a 1-ulp flip there moves an output by up to
  ``2^-10 * max|want|``, which is its added allowance;
- the complex path within ``1e-6 * max|want|``;
- the facade's single-channel pieces (``freq_xlating_fir``,
  ``channelize_list``, ``channelize_list_planes``, each held to JAX's on
  the same mixer table): rtol 1e-5, atol ``1e-6 * max|want|`` (float32
  sums of the real taps in another order); the host tables
  (``make_mixer_planes``, ``make_mixer_table``) and
  ``fractional_resampler`` equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lora_tpu import channelizer as jch
from lora_tpu.ops.pallas_kernels import pfb_fir_pallas
from lora_tpu.ops.xfer import pack_iq as jpack_iq

from lora_tpu_torch import PolyphaseChannelizer
from lora_tpu_torch import channelizer as ch
from lora_tpu_torch.convert import load_channelizer
from lora_tpu_torch.ops.cuda_kernels import _pfb_vector_width, pfb_fir_kernel, pfb_fir_planes
from lora_tpu_torch.ops.xfer import pack_iq


def wideband(M, n_vec, extra=0, seed=0):
    """Noise plus three per-channel tones (tests/test_pfb_planes.py)."""
    rng = np.random.default_rng(seed)
    L = M * n_vec + extra
    x = (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(np.complex64)
    n = np.arange(L)
    for c in (1, M // 2, M - 3):
        x += 0.5 * np.exp(2j * np.pi * (c / M) * n).astype(np.complex64)
    return x


def port(M, device="cpu"):
    return PolyphaseChannelizer.for_lora(M * 250e3, M, device=device)


@pytest.mark.parametrize("args", [(1.0, 2e6, 77500.0, 62500.0), (1.0, 250e3, 77500.0, 10000.0),
                                  (0.5, 1e6, 40000.0, 20000.0)])
def test_firdes_equal_jax(args):
    np.testing.assert_array_equal(ch.firdes_low_pass(*args), jch.firdes_low_pass(*args))
    assert ch.firdes_low_pass(*args).dtype == np.float32


def test_lora_channel_taps_and_freqs_equal_jax():
    np.testing.assert_array_equal(ch.lora_channel_taps(1e6, 125e3),
                                  jch.lora_channel_taps(1e6, 125e3))
    for rate, M in ((2e6, 8), (256e6, 1024), (1e6, 5)):
        np.testing.assert_array_equal(ch.pfb_channel_freqs(rate, M),
                                      jch.pfb_channel_freqs(rate, M))


@pytest.mark.parametrize("M", [1, 8, 128, 1000, 1024, 4096])
def test_for_lora_h_poly_equal_jax(M):
    j = jch.PolyphaseChannelizer.for_lora(M * 250e3, M)
    p = port(M)
    assert (p.M, p.K) == (j.M, j.K)
    assert p.h_poly.dtype == np.float32
    np.testing.assert_array_equal(p.h_poly, j.h_poly)
    assert PolyphaseChannelizer._two_stage_split(M, 2048) == \
        jch.PolyphaseChannelizer._two_stage_split(M, 2048)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_pfb_fir_planes_matches_pallas_interpret(out):
    """The Pallas K4 itself (interpret mode, as tests/test_pfb_planes.py
    runs it) at M = 128, n_vec = 512 + K + 1 (not a multiple of 16)."""
    M = 128
    p = port(M)
    n_vec = 512 + p.K + 1
    x = wideband(M, n_vec, seed=3)
    want = np.asarray(pfb_fir_pallas(jnp.asarray(jpack_iq(x)), p.h_poly,
                                     out_dtype=getattr(jnp, out), interpret=True))
    got = pfb_fir_planes(pack_iq(x, device="cpu"), torch.from_numpy(p.h_poly),
                         getattr(torch, out))
    assert tuple(got.shape) == want.shape == (2, n_vec - p.K + 1, M)
    got, want = got.float().numpy(), want.astype(np.float32)
    if out == "float32":
        bound = 1e-6 * np.abs(p.h_poly).sum(0).max() * np.abs(x).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    else:
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,extra", [(8, 0), (1000, 37), (128, 127)])
def test_wrapper_cpu_takes_plain_version(M, extra, dtype):
    """A CPU tensor takes the plain version; L need not be a multiple of M."""
    p = port(M)
    xf = pack_iq(wideband(M, 3 * p.K, extra=extra), device="cpu").to(dtype)
    h = torch.from_numpy(p.h_poly)
    before = pfb_fir_kernel.launches
    got = pfb_fir_kernel(xf, h, torch.bfloat16)
    assert pfb_fir_kernel.launches == before
    assert torch.equal(got, pfb_fir_planes(xf, h, torch.bfloat16))
    assert tuple(got.shape) == (2, 2 * p.K + 1, M)


def test_wrapper_writes_into_a_padded_buffer():
    """``out=``: the first n_out rows of an [R, 2, M] buffer take the
    result; the rows past them keep what they held."""
    p = port(128)
    xf = pack_iq(wideband(128, 40), device="cpu")
    h = torch.from_numpy(p.h_poly)
    n_out = 40 - p.K + 1
    buf = torch.full((n_out + 5, 2, 128), 7.0)
    got = pfb_fir_kernel(xf, h, out=buf)
    assert torch.equal(got, pfb_fir_planes(xf, h))
    assert torch.equal(buf[:n_out].transpose(0, 1), got)
    assert bool((buf[n_out:] == 7.0).all())
    with pytest.raises(ValueError, match="out must be"):
        pfb_fir_kernel(xf, h, out=torch.zeros((n_out - 1, 2, 128)))


@pytest.mark.parametrize("xf,h,out,err", [
    (torch.zeros(2, 64, dtype=torch.float16), torch.ones(2, 8), torch.float32, TypeError),
    (torch.zeros(2, 64), torch.ones(2, 8, dtype=torch.float64), torch.float32, TypeError),
    (torch.zeros(2, 64), torch.ones(2, 8), torch.float16, TypeError),
    (torch.zeros(3, 64), torch.ones(2, 8), torch.float32, ValueError),
    (torch.zeros(2, 64), torch.ones(9, 8), torch.float32, ValueError),       # n_vec < K
    (torch.zeros(2, 64), torch.ones(8), torch.float32, ValueError),
], ids=["fp16-planes", "f64-taps", "fp16-out", "three-planes", "short", "1d-taps"])
def test_wrapper_refuses(xf, h, out, err):
    with pytest.raises(err):
        pfb_fir_kernel(xf, h, out)


def _width_case(case):
    """``(planes, taps, output buffer)`` of a vector-width case, built when
    the test runs."""
    f32, bf16 = torch.float32, torch.bfloat16
    in_dt = bf16 if "bf16-in" in case else f32
    out_dt = bf16 if "bf16-out" in case else f32
    M = {"odd-M": 1001, "M-6": 6, "M-1020": 1020}.get(case.split(":")[0], 1024)
    L = 8 * M
    xf = torch.zeros((2, L), dtype=in_dt)
    h = torch.ones((4, M))
    out = torch.empty((5, 2, M), dtype=out_dt)
    if case.startswith("odd-stride"):
        xf = torch.zeros((2, L + 1), dtype=in_dt)[:, :L]
    elif case.startswith("offset-planes"):
        xf = torch.zeros((2, L + 1), dtype=in_dt)[:, 1:]
    elif case.startswith("offset-taps"):
        h = torch.ones(4 * M + 1)[1:].view(4, M)
    elif case.startswith("offset-out"):
        out = torch.empty(10 * M + 1, dtype=out_dt)[1:].view(5, 2, M)
    return xf, h, out


@pytest.mark.parametrize("case,want", [
    ("aligned:f32-in,f32-out", 4), ("aligned:f32-in,bf16-out", 4),
    ("aligned:bf16-in,f32-out", 8), ("aligned:bf16-in,bf16-out", 8),
    ("odd-stride:f32-in", 1), ("odd-stride:bf16-in", 1),
    ("odd-M:f32-in", 1), ("odd-M:bf16-in", 1), ("M-6:f32-in", 1),
    ("M-1020:f32-in", 4), ("M-1020:bf16-in", 1),
    ("offset-planes:f32-in", 1), ("offset-taps:f32-in", 1),
    ("offset-out:f32-in,f32-out", 1), ("offset-out:bf16-in,bf16-out", 1),
])
def test_vector_width(case, want):
    """The polyphase FIR kernel's width: 16 bytes of input a thread (4
    float32 or 8 bf16 branches) where the planes' base and stride, M, the
    taps and the output buffer allow it, else the scalar instantiation."""
    xf, h, out = _width_case(case)
    assert _pfb_vector_width(xf, h, out) == want


# (M, max_dft_matmul, extra samples): single-stage DFT product, the
# two-stage split forced by a small cap, and the FFT branch (16 does not
# split into factors >= 8 under a cap of 8)
GEOMS = [(8, 2048, 0), (128, 2048, 5), (64, 16, 0), (128, 16, 3), (16, 8, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,cap,extra", GEOMS,
                         ids=["M8", "M128", "two-stage-64", "two-stage-128", "fft-16"])
def test_planes_match_jax(M, cap, extra, dtype):
    x = wideband(M, 256 if M <= 64 else 128, extra=extra)
    j = jch.PolyphaseChannelizer.for_lora(M * 250e3, M)
    want = np.asarray(j.planes(jnp.asarray(jpack_iq(x)), out_dtype=getattr(jnp, dtype),
                               max_dft_matmul=cap)).astype(np.float32)
    got = port(M).planes(pack_iq(x, device="cpu"), out_dtype=getattr(torch, dtype),
                         max_dft_matmul=cap)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    got = got.float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 2e-6 * scale
    else:
        two_stage = M > cap and PolyphaseChannelizer._two_stage_split(M, cap) is not None
        allow = 2.0 ** -7 * np.abs(want) + (2.0 ** -10 if two_stage else 1e-6) * scale
        assert np.all(err <= allow)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_coarse_filterbank_planes_match_jax(n):
    """The subband path's coarse filterbank (``parallel/sharding.py``: the
    prototype over ``n`` subbands, K = 13), whose branch FIR the polyphase
    kernel's narrow tile runs on the card: the port's float32 planes
    against lora_tpu's, whose FIR at ``M % 128 != 0`` is its jnp
    shifted-slice sum (the Pallas kernel takes no such M)."""
    rate = 250e3 * 1280 * n
    spacing = rate / n
    j = jch.PolyphaseChannelizer(n, jch.firdes_low_pass(1.0, rate, 0.42 * spacing,
                                                        spacing / 5.0))
    p = PolyphaseChannelizer(n, ch.firdes_low_pass(1.0, rate, 0.42 * spacing, spacing / 5.0),
                             device="cpu")
    assert p.K == j.K == 13
    x = wideband(n, 12288 // n, extra=3)
    want = np.asarray(j.planes(jnp.asarray(jpack_iq(x)))).astype(np.float32)
    got = p.planes(pack_iq(x, device="cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("M", [8, 64])
def test_complex_path_matches_jax(M):
    x = wideband(M, 256)
    j = jch.PolyphaseChannelizer.for_lora(M * 250e3, M)
    want = np.asarray(j(jnp.asarray(x)))
    got = port(M)(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_load_channelizer_installs_jax_state():
    """JAX's taps and DFT planes installed on a port channelizer built from
    other taps of the same length: its planes then follow JAX's."""
    M = 64
    j = jch.PolyphaseChannelizer.for_lora(M * 250e3, M)
    p = PolyphaseChannelizer(M, np.ones(M * j.K, np.float32), device="cpu")
    x = wideband(M, 128)
    before = p.planes(pack_iq(x, device="cpu"))
    load_channelizer(p, j.h_poly, dft=j._dft_planes(np.float32))
    np.testing.assert_array_equal(p.h_poly, j.h_poly)
    want = np.asarray(j.planes(jnp.asarray(jpack_iq(x))))
    got = p.planes(pack_iq(x, device="cpu")).numpy()
    assert np.abs(before.numpy() - want).max() > 1.0
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="expected"):
        load_channelizer(p, j.h_poly[:, :32])
    with pytest.raises(ValueError, match="expected"):
        load_channelizer(p, j.h_poly, dft=(np.zeros((M, M)), np.zeros((M, 8))))


# ------------------------------------------- the facade's channelizers
def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def _iq(L, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(np.complex64)


@pytest.mark.parametrize("L,chunk", [(5000, 1 << 20), (5003, 1024)])
def test_mixer_tables_equal_jax(L, chunk):
    offs = [-312.5e3, 0.0, 125e3, 433.1e3]
    np.testing.assert_array_equal(ch.make_mixer_planes(offs, 1e6, L, chunk=chunk),
                                  jch.make_mixer_planes(offs, 1e6, L, chunk=chunk))
    np.testing.assert_array_equal(ch.make_mixer_table(offs, 1e6, L),
                                  jch.make_mixer_table(offs, 1e6, L))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("offset", [0.0, 200e3, -137.5e3])
def test_freq_xlating_fir_matches_jax(D, offset):
    x = _iq(30_011)
    taps = ch.lora_channel_taps(1e6, 125e3)
    got = ch.freq_xlating_fir(x, taps, offset, 1e6, D, device="cpu")
    assert got.dtype == torch.complex64
    _close(got.numpy(), jch.freq_xlating_fir(x, taps, offset, 1e6, D))
    # a complex tensor or planes give the same stream
    np.testing.assert_array_equal(
        ch.freq_xlating_fir(torch.from_numpy(x), taps, offset, 1e6, D).numpy(), got.numpy())


@pytest.mark.parametrize("D", [1, 4])
def test_channelize_list_matches_jax(D):
    x = _iq(20_000, seed=6)
    taps = ch.lora_channel_taps(1e6, 125e3)
    offs = [-300e3, 0.0, 250e3]
    mixers = jch.make_mixer_table(offs, 1e6, len(x))
    want = np.asarray(jch.channelize_list(x, taps, offs, 1e6, D, mixers=mixers))
    _close(ch.channelize_list(x, taps, offs, 1e6, D, mixers=mixers, device="cpu").numpy(), want)
    # the default table is the same float64 one
    _close(ch.channelize_list(x, taps, offs, 1e6, D, device="cpu").numpy(), want)
    xf = pack_iq(x, device="cpu")
    mp = ch.make_mixer_planes(offs, 1e6, len(x))
    got = ch.channelize_list_planes(xf, taps, mp, D)
    _close(got.numpy(), jch.channelize_list_planes(jnp.asarray(xf.numpy()), taps,
                                                   jnp.asarray(mp), D))


def test_fractional_resampler_equals_jax():
    x = _iq(40_000, seed=8)
    for ratio in (1.024, 1.0 / 1.024, 1.0 + 30e-6, 2.5):
        np.testing.assert_array_equal(ch.fractional_resampler(x, ratio),
                                      jch.fractional_resampler(x, ratio))
