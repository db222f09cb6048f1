"""The port's LoRaWAN plan gateway and its channelizer against lora_tpu's,
on the CPU.

- The host table builders (mixer factors, folded FIR matrix, output ramp
  factors) run the same numpy operations: bit-equal.
- ``_decimating_fir`` and the factored channelizer against JAX's: rtol and
  atol 1e-4 (tests/test_plan_stream.py's tolerance; float32 sums in
  another order).
- The plain version of the fused kernel against JAX's Pallas kernel in
  interpret mode (rtol = atol = 2e-4, as tests/test_plan_stream.py holds
  the Pallas kernel to the factored path), and past the Pallas kernel's
  geometry gate against JAX's factored path.
- The CUDA kernel's tables (``fused_mix_tables``) against their float64
  definition and JAX's mixer factors, and a torch mirror of the kernel's
  factored arithmetic (blocks of 256 outputs, the block's ramp phasor,
  the ramp's inner table, the phase table, the real taps) against JAX's
  Pallas kernel in interpret mode (rtol = atol = 2e-4).
- ``PlanGateway.run`` against JAX's on tests/test_plans.py's captures, on
  the port's own tables and on JAX's taps, folded matrix and ramp, and on
  a short US915 capture (23 channels at 8 Msps): frames equal field by
  field (snr rtol 1e-5, cfo atol 1 Hz); the fused and the factored
  channelizer decode the same frames.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lora_tpu import channelizer as jchan
from lora_tpu import plans as jplans
from lora_tpu.config import LoRaConfig as JConfig
from lora_tpu.ops.xfer import pack_iq as jpack_iq
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import PlanGateway, channelizer as chan, plans
from lora_tpu_torch.convert import load_plan_tables
from lora_tpu_torch.ops.cuda_kernels import (fused_channelize_kernel,
                                             fused_channelize_planes)

from test_torch_multi_sf import assert_frames_equal


def _iq(L, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, L) + 1j * rng.normal(0, 1, L)).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain_fused(xf, taps, offs, rate, D, tile=1024):
    """The plain fused channelizer with tables built on the host."""
    g2, ramp, _ = chan.fused_tables(offs, rate, taps, D, xf.shape[-1], "cpu", tile)
    return fused_channelize_planes(_t(xf), g2, ramp, D, len(taps), tile)


def _mirror_factored(xf, taps, offs, rate, D, T=256, tile=1024):
    """The CUDA kernel's factored arithmetic, in torch: for each block of
    ``T`` outputs from ``n0`` on, ``y_c[n] = R_c[n0] * sum_{j, d} h[j*D +
    d] * x[(n + j)*D + d] * rho_c[n - n0 + j] * phi_c[d]`` with ``R_c[n0]``
    the output ramp at ``n0`` (outer times inner factor), ``rho`` the
    ramp's inner table and ``(h, phi)`` from ``fused_tables``; float32
    phasor products, mixed sample by mixed sample."""
    _, (o_re, o_im, i_re, i_im), (h, phi) = chan.fused_tables(offs, rate, taps, D,
                                                              xf.shape[-1], "cpu", tile)
    K = h.numel() // D
    L = xf.shape[-1]
    n_out = (L - len(taps)) // D + 1
    rows = T + K - 1
    assert rows <= tile
    nblk = -(-n_out // T)
    xp = torch.nn.functional.pad(_t(xf), (0, (nblk * T + K - 1) * D - L))
    x = torch.complex(xp[0], xp[1])
    outer, inner = torch.complex(o_re, o_im), torch.complex(i_re, i_im)
    ph = torch.complex(phi[:, 0], phi[:, 1])                       # [C, D]
    hk = h.view(K, D)
    blocks = []
    for n0 in range(0, nblk * T, T):
        R = outer[:, n0 // tile] * inner[:, n0 % tile]              # [C]
        z = x[n0 * D:(n0 + rows) * D].view(rows, D)[None] \
            * (inner[:, :rows, None] * ph[:, None, :])              # [C, rows, D]
        y = sum((z[:, j:j + T] * hk[j]).sum(-1) for j in range(K))  # [C, T]
        blocks.append(R[:, None] * y)
    y = torch.cat(blocks, dim=1)[:, :n_out]
    return torch.stack([y.real, y.imag], dim=1)


# ----------------------------------------------------------- host builders
@pytest.mark.parametrize("D,ntaps,C,L", [(4, 19, 3, 4429), (8, 77, 7, 3604480),
                                         (32, 309, 23, 14417920), (1, 31, 2, 3000)])
def test_host_builders_bit_equal(D, ntaps, C, L):
    taps = np.random.default_rng(D).normal(0, 1, ntaps).astype(np.float32)
    offs = np.linspace(-0.4e6 * D / 8, 0.4e6 * D / 8, C)
    rate = D * 250e3
    for a, b in zip(chan.make_mixer_factors(offs, rate, L),
                    jchan.make_mixer_factors(offs, rate, L)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(chan.make_fused_fir_matrix(offs, rate, taps, D),
                          jchan.make_fused_fir_matrix(offs, rate, taps, D))
    nb = -(-((L - ntaps) // D + 1) // 1024)
    for a, b in zip(chan.make_output_ramp_factors(offs, rate, D, nb, 1024),
                    jchan.make_output_ramp_factors(offs, rate, D, nb, 1024)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the tables for a block of L samples, as the gateway and the kernel take them
    g2, ramp, (h, phi) = chan.fused_tables(offs, rate, taps, D, L, "cpu")
    K = -(-ntaps // D)
    want = (jchan.make_fused_fir_matrix(offs, rate, taps, D),
            *jchan.make_output_ramp_factors(offs, rate, D, nb, 1024),
            np.pad(taps, (0, K * D - ntaps)), jchan.make_mixer_factors(offs, rate, D, tile=D)[1])
    for a, b in zip((g2, *ramp, h, phi), want):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("D,ntaps,C", [(8, 77, 7), (32, 309, 23), (1, 31, 2), (3, 20, 9)])
def test_fused_mix_tables_float64_definition(D, ntaps, C):
    """``h`` is the taps zero-padded to ``K*D``; ``phi[c, :, d]`` is
    ``exp(-2j pi frac(a_c d))`` rounded once to float32."""
    taps = np.random.default_rng(D).normal(0, 1, ntaps).astype(np.float32)
    rate = D * 250e3
    offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
    h, phi = chan.fused_mix_tables(offs, rate, taps, D)
    K = -(-ntaps // D)
    assert h.dtype == phi.dtype == np.float32
    assert h.shape == (K * D,) and np.array_equal(h[:ntaps], taps) and not h[ntaps:].any()
    a = offs / rate
    want = np.exp(-2j * np.pi * ((a[:, None] * np.arange(D)) % 1.0))
    assert phi.shape == (C, 2, D)
    np.testing.assert_allclose(phi[:, 0], want.real, rtol=0, atol=2 ** -24)
    np.testing.assert_allclose(phi[:, 1], want.imag, rtol=0, atol=2 ** -24)
    # with the ramp's inner table, the mixer of sample (n0 + q)*D + d
    n0, tile = 3 * 256, 1024
    o_re, o_im, i_re, i_im = chan.make_output_ramp_factors(offs, rate, D, 4, tile)
    q, d = np.meshgrid(np.arange(256 + K - 1), np.arange(D), indexing="ij")
    got = ((o_re[:, 0] + 1j * o_im[:, 0]) * (i_re[:, n0] + 1j * i_im[:, n0]))[:, None, None] \
        * (i_re[:, :256 + K - 1] + 1j * i_im[:, :256 + K - 1])[:, :, None] \
        * (phi[:, 0] + 1j * phi[:, 1])[:, None, :]
    s = (n0 + q) * D + d
    np.testing.assert_allclose(got, np.exp(-2j * np.pi * ((a[:, None, None] * s) % 1.0)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("D,ntaps,C,L", [(8, 77, 7, 33000), (32, 309, 23, 45000),
                                         (4, 19, 3, 4429), (8, 501, 3, 20000)],
                         ids=["EU868", "US915", "ragged", "K-63"])
def test_factored_mirror_matches_pallas_interpret(D, ntaps, C, L):
    """The kernel's factored arithmetic against JAX's folded Pallas kernel:
    the plan shapes with their own taps (US915 on a short block), a ragged
    L and K = 63 (four passes of 16 tap rows in the kernel)."""
    rate = D * 250e3
    if ntaps in (77, 309):
        taps = chan.firdes_low_pass(1.0, rate, 77.5e3, 62.5e3)
        assert len(taps) == ntaps
    else:
        taps = np.random.default_rng(9).normal(0, 0.1, ntaps).astype(np.float32)
    offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
    xf = jpack_iq(_iq(L, 10))
    want = jchan.channelize_list_planes_fused(jnp.asarray(xf), taps, offs, rate, D, tile=1024,
                                              interpret=True)
    assert want is not None
    got = _mirror_factored(xf, taps, offs, rate, D)
    assert got.shape == (C, 2, (L - ntaps) // D + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


# ------------------------------------------------------- the factored path
@pytest.mark.parametrize("D,Nt,L", [(4, 5, 100), (4, 5, 101), (4, 5, 103), (8, 77, 4096),
                                    (8, 77, 4099), (2, 31, 999), (32, 421, 65536 + 17),
                                    (1, 31, 777), (2, 301, 2000)],
                         ids=lambda v: str(v))
def test_decimating_fir_matches_jax(D, Nt, L):
    """tests/test_plan_stream.py:60-61's geometries, D = 1 and K = 151 > 64
    (both the convolution branch)."""
    rng = np.random.default_rng(1)
    taps = rng.normal(0, 1, Nt).astype(np.float32)
    m = rng.normal(0, 1, (2, L)).astype(np.float32)
    want = np.asarray(jchan._decimating_fir(jnp.asarray(m), taps, D))
    got = chan._decimating_fir(_t(m), taps, D)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D,ntaps,C,L", [(4, 19, 3, 4429), (8, 77, 5, 33000),
                                         (32, 309, 2, 45000), (1, 31, 2, 3000)])
def test_factored_channelizer_matches_jax(D, ntaps, C, L):
    rng = np.random.default_rng(2)
    taps = rng.normal(0, 1, ntaps).astype(np.float32)
    offs = np.linspace(-300e3, 300e3, C)
    xf = jpack_iq(_iq(L, 3))
    outer, inner = jchan.make_mixer_factors(offs, 2e6, L)
    want = np.asarray(jchan.channelize_list_planes_factored(jnp.asarray(xf), taps, outer,
                                                            inner, D))
    got = chan.channelize_list_planes_factored(_t(xf), taps, _t(outer), _t(inner), D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------- the fused channelizer
@pytest.mark.parametrize("D,ntaps,C,L", [(4, 19, 3, 4429), (8, 77, 5, 33000),
                                         (2, 9, 1, 2100), (32, 309, 2, 45000)])
def test_plain_fused_matches_pallas_interpret(D, ntaps, C, L):
    """tests/test_plan_stream.py:81-82's geometries, ``tile=128``."""
    rng = np.random.default_rng(3)
    taps = rng.normal(0, 1, ntaps).astype(np.float32)
    offs = np.linspace(-300e3, 300e3, C)
    xf = jpack_iq(_iq(L, 4))
    want = jchan.channelize_list_planes_fused(jnp.asarray(xf), taps, offs, 2e6, D, tile=128,
                                              interpret=True)
    assert want is not None
    got = _plain_fused(xf, taps, offs, 2e6, D, tile=128)
    assert got.shape == (C, 2, (L - ntaps) // D + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("D,ntaps,C,L", [(2, 301, 2, 5000), (16, 1001, 3, 40000),
                                         (1, 31, 2, 3000)], ids=["K-151", "2DK-2016", "D-1"])
def test_plain_fused_past_the_pallas_gate(D, ntaps, C, L):
    """Geometries the Pallas kernel refuses (K > 128, 2DK > 1024, D < 2):
    the plain version against JAX's factored path."""
    from lora_tpu.ops.pallas_kernels import fused_channelize_geometry_ok

    assert not fused_channelize_geometry_ok(D, ntaps, 1024)
    rng = np.random.default_rng(5)
    taps = rng.normal(0, 0.1, ntaps).astype(np.float32)
    offs = np.linspace(-0.3 * D * 250e3, 0.3 * D * 250e3, C)
    rate = D * 250e3
    xf = jpack_iq(_iq(L, 6))
    outer, inner = jchan.make_mixer_factors(offs, rate, L)
    want = np.asarray(jchan.channelize_list_planes_factored(jnp.asarray(xf), taps, outer,
                                                            inner, D))
    got = _plain_fused(xf, taps, offs, rate, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    D, ntaps, C, L = 8, 77, 3, 9000
    taps = np.random.default_rng(7).normal(0, 1, ntaps).astype(np.float32)
    offs = np.array([-200e3, 0.0, 400e3])
    xf = torch.from_numpy(jpack_iq(_iq(L, 8)))
    g2 = _t(chan.make_fused_fir_matrix(offs, 2e6, taps, D))
    n_out = (L - ntaps) // D + 1
    ramp = tuple(map(_t, chan.make_output_ramp_factors(offs, 2e6, D, -(-n_out // 256), 256)))
    mix = tuple(map(_t, chan.fused_mix_tables(offs, 2e6, taps, D)))
    before = fused_channelize_kernel.launches
    got = fused_channelize_kernel(xf, g2, ramp, D, ntaps, mix)
    assert fused_channelize_kernel.launches == before
    assert torch.equal(got, fused_channelize_planes(xf, g2, ramp, D, ntaps, 256))


@pytest.mark.parametrize("case", ["f64", "complex", "three-planes", "g2-width", "g2-odd-rows",
                                  "ramp-nb", "ramp-tile", "three-factors", "short-block",
                                  "numpy-table", "mix-h-length", "mix-phi-shape", "mix-f64",
                                  "mix-one-table", "mix-numpy"])
def test_kernel_wrapper_refuses(case):
    D, ntaps, C, L = 4, 19, 2, 4000
    xf = torch.zeros((2, L))
    g2 = torch.zeros((2 * C, 5 * 2 * D))
    n_out = (L - ntaps) // D + 1
    nb = -(-n_out // 128)
    ramp = [torch.zeros((C, nb)), torch.zeros((C, nb)), torch.zeros((C, 128)),
            torch.zeros((C, 128))]
    mix = (torch.zeros(5 * D), torch.zeros((C, 2, D)))
    if case == "mix-h-length":
        mix = (torch.zeros(ntaps), mix[1])
    elif case == "mix-phi-shape":
        mix = (mix[0], torch.zeros((C, D)))
    elif case == "mix-f64":
        mix = (mix[0].double(), mix[1])
    elif case == "mix-one-table":
        mix = mix[:1]
    elif case == "mix-numpy":
        mix = (mix[0], mix[1].numpy())
    elif case == "f64":
        xf = xf.double()
    elif case == "complex":
        xf = torch.zeros((2, L), dtype=torch.complex64)
    elif case == "three-planes":
        xf = torch.zeros((3, L))
    elif case == "g2-width":
        g2 = torch.zeros((2 * C, 4 * 2 * D))
    elif case == "g2-odd-rows":
        g2 = torch.zeros((2 * C + 1, 5 * 2 * D))
    elif case == "ramp-nb":
        ramp[0] = ramp[1] = torch.zeros((C, nb + 1))
    elif case == "ramp-tile":
        ramp[2] = torch.zeros((C, 64))
    elif case == "three-factors":
        ramp = ramp[:3]
    elif case == "short-block":
        xf = torch.zeros((2, ntaps - 1))
    else:
        g2 = g2.numpy()
    before = fused_channelize_kernel.launches
    with pytest.raises((TypeError, ValueError)):
        fused_channelize_kernel(xf, g2, tuple(ramp), D, ntaps, mix)
    assert fused_channelize_kernel.launches == before


# ----------------------------------------------------------------- gateway
def test_plan_constants_equal_jax():
    assert plans.EU868 == jplans.EU868 and plans.US915 == jplans.US915
    assert plans.AU915 == jplans.AU915 and plans.PLANS == jplans.PLANS


def _capture(center, rate, placements, L, seed):
    """tests/test_plans.py's captures: noise sigma 1e-4 a part and one
    packet per placement ``(sf, f_abs, payload, pos, cfo, snr)``."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for i, (sf, f_abs, payload, pos, cfo, snr) in enumerate(placements):
        wcfg = JConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, payload, cfo_hz=cfo, snr_db=snr, seed=100 + i)
        off = f_abs - center
        x[pos:pos + len(pkt)] += (
            pkt * np.exp(2j * np.pi * off / rate * t[pos:pos + len(pkt)])).astype(np.complex64)
    return x


CENTER, RATE = 868.3e6, 2e6
SPS8, SPS9 = int(2 ** 8 * RATE / 125e3), int(2 ** 9 * RATE / 125e3)
CASES = {
    # tests/test_plans.py:24-60: SF7 and SF8, no impairment
    "clean": ((7, 8), 40 * SPS8, 5,
              [(7, 868.1e6, b"\x42", 2 * 2 ** 7 * 16, 0.0, None),
               (8, 868.5e6, b"\x24", 2 * SPS8, 0.0, None)]),
    # tests/test_plans.py:71-105: SF7 and SF9 with CFO and 10-12 dB SNR
    "cfo-noise": ((7, 9), 56 * SPS9, 11,
                  [(7, 868.1e6, b"\x42\x43", 2 * SPS9, 450.0, 10.0),
                   (9, 867.9e6, b"\x24", 18 * SPS9, -380.0, 12.0)]),
}
KW = dict(pool=8, max_candidates=2, max_symbols=16, sfd_search=10, demod_method="fft")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    sfs, L, seed, placements = CASES[request.param]
    x = _capture(CENTER, RATE, placements, L, seed)
    jgw = jplans.PlanGateway("EU868", CENTER, RATE, sfs=sfs, **KW)
    return request.param, sfs, x, jgw.run(x), placements


@pytest.mark.parametrize("tables", ["own", "loaded"])
def test_plan_gateway_run_matches_jax(case, tables):
    name, sfs, x, want, placements = case
    gw = PlanGateway("EU868", CENTER, RATE, sfs=sfs, device="cpu", **KW)
    assert gw.channels == [868.1e6, 868.3e6, 868.5e6, 867.5e6, 867.7e6, 867.9e6]
    assert gw.decim == 8 and gw.pool == 8
    if tables == "loaded":
        jgw = jplans.PlanGateway("EU868", CENTER, RATE, sfs=sfs, fused=True,
                                 fused_interpret=True, **KW)
        L = len(x) + gw.max_pkt_samples * gw.decim
        n_out = (L - len(jgw.taps)) // jgw.decim + 1
        ramp = jchan.make_output_ramp_factors(jgw.offsets, RATE, jgw.decim,
                                              -(-n_out // 1024), 1024)
        load_plan_tables(gw, jgw.taps, jgw._g2, ramp=ramp, length=L)
        assert np.array_equal(gw._g2.numpy(), jgw._g2)
    got = gw.run(x)
    decoded = {(f.tap_header.sf, f.tap_header.frequency): f.payload for f in got}
    for sf, f_abs, payload, *_ in placements:
        assert decoded[(sf, int(f_abs))][:len(payload)] == payload
    assert all(0 <= f.channel < len(gw.channels) for f in got)
    assert_frames_equal(got, want)


def test_us915_plan_gateway_run_matches_jax():
    """The US915 plan at 903.0 MHz, 8 Msps (23 channels in band, D = 32,
    309 taps, the fused channelizer's plain version) against JAX's
    gateway on a short capture with three SF7 packets, one with CFO and
    noise."""
    center, rate = 903.0e6, 8e6
    sps7 = int(2 ** 7 * rate / 125e3)
    placements = [(7, 902.5e6, b"\x11", 2 * sps7, 0.0, None),
                  (7, 903.7e6, b"\x22\x23", 3 * sps7, 300.0, 12.0),
                  (7, 906.1e6, b"\x33", 5 * sps7, 0.0, None)]
    x = _capture(center, rate, placements, 44 * sps7, 12)
    kw = dict(KW, sfs=(7,))
    gw = PlanGateway("US915", center, rate, device="cpu", **kw)
    assert len(gw.channels) == 23 and gw.decim == 32 and len(gw.taps) == 309 and gw.fused
    got = gw.run(x)
    decoded = {(f.tap_header.sf, f.tap_header.frequency): f.payload for f in got}
    for sf, f_abs, payload, *_ in placements:
        assert decoded[(sf, int(f_abs))][:len(payload)] == payload
    assert_frames_equal(got, jplans.PlanGateway("US915", center, rate, **kw).run(x))


def test_fused_and_factored_decode_the_same_frames():
    """tests/test_plan_stream.py:155-177: the fused channelizer against the
    factored one, end to end."""
    center, rate = 867.3e6, 1e6
    sps8 = int(2 ** 8 * rate / 125e3)
    placements = [(7, 867.1e6, b"\x42\x43", 2 * sps8, 0.0, None),
                  (8, 867.5e6, b"\x24", 14 * sps8, 0.0, None)]
    x = _capture(center, rate, placements, 60 * sps8, 7)
    kw = dict(KW, sfs=(7, 8), device="cpu")
    gw = PlanGateway("EU868", center, rate, **kw)
    assert gw.fused and gw.channels == [867.1e6, 867.3e6, 867.5e6]
    fused = gw.run(x)
    gw.fused = False
    factored = gw.run(x)
    assert sorted((f.tap_header.sf, f.tap_header.frequency) for f in fused) == \
        sorted((sf, int(fa)) for sf, fa, *_ in placements)
    for f, (_, _, payload, *_) in zip(sorted(fused, key=lambda f: f.tap_header.sf), placements):
        assert f.payload[:len(payload)] == payload
    assert_frames_equal(fused, factored)
    assert_frames_equal(PlanGateway("EU868", center, rate, fused=False, **kw).run(x), factored)


def test_plan_gateway_options():
    with pytest.raises(ValueError):
        PlanGateway("EU868", 868.3e6, 2.1e6, device="cpu")   # not a chan_rate multiple
    with pytest.raises(ValueError):
        PlanGateway("US915", 868.3e6, 2e6, device="cpu")     # no channel in band
    with pytest.raises(ValueError):
        PlanGateway("bogus", 868.3e6, 2e6, device="cpu")
    with pytest.raises(TypeError):
        PlanGateway("EU868", 868.3e6, 2e6, plane_dtype=torch.float16, device="cpu")
    gw = PlanGateway("us915", 903.0e6, 8e6, sfs=(8, 7, 8), max_symbols=12, device="cpu")
    assert len(gw.channels) == 23 and gw.decim == 32 and len(gw.taps) == 309
    assert gw.sfs == (8, 7) and gw.pool == 46 and gw.max_pkt_samples == gw.rxs[8].pkt_samples
    assert tuple(gw._g2.shape) == (46, 10 * 64) and gw._g2.device.type == "cpu"
    assert [tuple(t.shape) for t in gw._mix] == [(320,), (23, 2, 32)]
    np.testing.assert_array_equal(gw.active, np.arange(23))
    assert gw.channel_freqs[0] == 902.3e6 + 0.2e6 * 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PlanGateway("EU868", 868.3e6, 2e6)


def test_plan_gateway_caches_two_lengths_and_computes_once():
    gw = PlanGateway("EU868", 868.3e6, 2e6, sfs=(7,), max_symbols=12, device="cpu")
    for L in (20000, 30000, 20000, 40000):
        cp = gw.channel_planes(torch.zeros((2, L)))
        assert cp.shape == (6, 2, (L - 77) // 8 + 1) and cp.is_contiguous()
    # first in, first out: 20000 was cached first, so 40000 evicts it
    assert list(gw._tables) == [("fused", 30000), ("fused", 40000)]
    before = fused_channelize_kernel.launches
    res = gw.process(torch.zeros((2, 20000)))
    assert sorted(res) == [7] and not res[7].valid.any()
    assert fused_channelize_kernel.launches == before   # the CPU takes the plain version


def test_load_plan_tables_refuses_wrong_shapes():
    gw = PlanGateway("EU868", 868.3e6, 2e6, sfs=(7,), max_symbols=12, device="cpu")
    C, D = 6, 8
    taps, g2 = gw.taps.copy(), gw._g2.numpy().copy()
    with pytest.raises(ValueError, match="g2"):
        load_plan_tables(gw, taps, g2[:-2])
    with pytest.raises(ValueError, match="g2"):
        load_plan_tables(gw, taps, g2[:, :-D])
    with pytest.raises(ValueError, match="taps"):
        load_plan_tables(gw, taps[:-D], g2)
    L = 20000
    nb = -(-((L - 77) // D + 1) // 1024)
    ramp = [np.zeros((C, nb), np.float32)] * 2 + [np.zeros((C, 1024), np.float32)] * 2
    with pytest.raises(ValueError, match="ramp"):
        load_plan_tables(gw, taps, g2, ramp=[np.zeros((C, nb + 1))] * 2 + ramp[2:], length=L)
    with pytest.raises(ValueError, match="length"):
        load_plan_tables(gw, taps, g2, ramp=ramp)
    load_plan_tables(gw, taps, g2, ramp=ramp, length=L)
    assert list(gw._tables) == [("fused", L)]
    # the kernel's tables follow the installed taps
    load_plan_tables(gw, 2 * taps, g2)
    assert torch.equal(gw._mix[0][:77], _t(2 * taps)) and not gw._mix[0][77:].any()
