"""The port's ops against lora_tpu's, on the same numpy inputs.

Tables must be equal (both are built in numpy the same way); the integer
decode chain bit-equal; the fold-path demod functions equal in their
integer outputs and within stated tolerances in their float ones:
Pearson and likeness atol 1e-5 (ifreq from atan2, whose last bit differs
between XLA's and torch's CPU implementations), CFO rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.ops import chirp as jchirp
from lora_tpu.ops import decode as jdec
from lora_tpu.ops import demod as jdemod
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate

from lora_tpu_torch import LoRaConfig
from lora_tpu_torch.ops import chirp, decode as dec, demod
from lora_tpu_torch.rx.dense import build_tables
from lora_tpu_torch.tx.modulator import modulate_frame


def _cfgs(**kw):
    return LoRaConfig(**kw), JConfig(**kw)


def jax_tables(jrx) -> dict:
    """A JAX DenseReceiver's host tables in the port's layout."""
    CW = jrx._deint_tables[0].shape[1]
    return dict(
        up=jrx._up, down=jrx._down, up_ifreq=jrx._up_ifreq,
        down_ifreq=jrx._down_ifreq, up_ifreq_v=jrx._up_ifreq_v,
        fold_mat=jrx._fold_mat, fold_up=jrx._fold_up,
        likeness_rows=jrx._likeness_rows, deint_tables=jrx._deint_tables,
        pay_lut=jrx._payload_lut(CW),
    )


@pytest.mark.parametrize("sf,samp_rate,reduced,S", [
    (7, 250e3, False, 24), (7, 1e6, False, 24), (8, 250e3, True, 48),
    (10, 250e3, False, 40)])
def test_tables_equal_jax(sf, samp_rate, reduced, S):
    cfg, jcfg = _cfgs(sf=sf, cr=4, samp_rate=samp_rate, reduced_rate=reduced)
    jrx = JDenseReceiver(jcfg, max_candidates=2, max_symbols=S, sfd_search=8,
                         demod_method="fft")
    want = jax_tables(jrx)
    got = build_tables(cfg, S)
    assert set(got) == set(want)
    for key in want:
        w = want[key] if isinstance(want[key], tuple) else (want[key],)
        g = got[key] if isinstance(got[key], tuple) else (got[key],)
        assert len(w) == len(g), key
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype, key
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


def test_chirps_equal_jax():
    cfg, jcfg = _cfgs(sf=9, cr=1, samp_rate=500e3)
    for a, b in zip(chirp.build_ideal_chirps(cfg), jchirp.build_ideal_chirps(jcfg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(chirp.tiled_upchirp_ifreq(cfg),
                                  jchirp.tiled_upchirp_ifreq(jcfg))


def test_modulator_equal_jax():
    cfg, jcfg = _cfgs(sf=8, cr=2, samp_rate=500e3, sync_word=0x34)
    for payload in (b"\x01", bytes(range(37))):
        a = modulate_frame(cfg, payload, pad_before=100, snr_db=12.0,
                           cfo_hz=321.0, seed=5)
        b = jmodulate(jcfg, payload, pad_before=100, snr_db=12.0,
                      cfo_hz=321.0, seed=5)
        np.testing.assert_array_equal(a, b)


def test_instantaneous_frequency_close_to_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 300)) + 1j * rng.normal(size=(4, 300))).astype(np.complex64)
    got = chirp.instantaneous_frequency(torch.from_numpy(x)).numpy()
    want = np.asarray(jchirp.instantaneous_frequency(jnp.asarray(x), xp=jnp))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------- integers
@pytest.mark.parametrize("sf", range(7, 13))
@pytest.mark.parametrize("cr", [1, 2, 3, 4])
def test_integer_chain_bit_equal(sf, cr):
    rng = np.random.default_rng(100 * sf + cr)
    B = 16
    reduced = sf >= 11
    ppm_hdr = sf - 2
    ppm = sf - 2 if reduced else sf
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731

    words = rng.integers(0, 2 ** ppm_hdr, (B, 8)).astype(np.int32)
    n_valid = rng.integers(0, 9, B).astype(np.int32)
    rows_t = dec.deinterleave_words(t(words), t(n_valid), ppm_hdr)
    rows_j = jdec.deinterleave_words(jnp.asarray(words), jnp.asarray(n_valid),
                                     ppm_hdr, xp=jnp)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    rows_t = dec.deinterleave_words(t(words), 8, ppm_hdr)
    rows_j = jdec.deinterleave_words(jnp.asarray(words), jnp.int32(8), ppm_hdr, xp=jnp)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))

    hdr_t = dec.decode_header(rows_t[:, :5])
    hdr_j = jdec.decode_header(rows_j[:, :5], xp=jnp)
    np.testing.assert_array_equal(hdr_t.numpy(), np.asarray(hdr_j))
    # random header bytes exercise every parse / checksum branch
    hb = rng.integers(0, 256, (64, 3)).astype(np.int32)
    for a, b in zip(dec.parse_header(t(hb)), jdec.parse_header(jnp.asarray(hb), xp=jnp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        dec.header_checksum_valid(t(hb)).numpy(),
        np.asarray(jdec.header_checksum_valid(jnp.asarray(hb), xp=jnp)))

    paylen = rng.integers(0, 262, 64).astype(np.int32)
    crs = rng.integers(0, 5, 64).astype(np.int32)
    np.testing.assert_array_equal(
        dec.payload_symbol_budget(t(paylen), t(crs), sf, reduced).numpy(),
        np.asarray(jdec.payload_symbol_budget(jnp.asarray(paylen), jnp.asarray(crs),
                                              sf, reduced, xp=jnp)))

    CW = ppm_hdr - 5 + (24 // 5) * ppm
    lut = jdec.make_payload_nibble_lut(CW)
    np.testing.assert_array_equal(dec.make_payload_nibble_lut(CW), lut)
    cws = rng.integers(0, 256, (B, CW)).astype(np.int32)
    n_cw = rng.integers(0, CW + 1, B).astype(np.int32)
    crv = np.full(B, cr, np.int32)
    crv[0] = 0  # cr 0 decodes to zeros
    got = dec.decode_payload_lut(t(cws), t(n_cw), t(crv), t(lut))
    want = jdec.decode_payload_lut(jnp.asarray(cws), jnp.asarray(n_cw),
                                   jnp.asarray(crv), jnp.asarray(lut), xp=jnp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- demod
@pytest.fixture(scope="module")
def clean_frame():
    """A clean SF7 frame at 250 ksps with a CFO of 210 Hz, and the port's
    tables (equal to lora_tpu's: test_tables_equal_jax)."""
    cfg, jcfg = _cfgs(sf=7, cr=4, samp_rate=250e3)
    sps = cfg.samples_per_symbol
    iq = modulate_frame(cfg, b"\xde\xad\xbe\xef", pad_before=3 * sps + 17,
                        cfo_hz=210.0)
    tables = build_tables(cfg, 24)
    return cfg, sps, iq, tables


def _windows(iq, starts, n):
    return np.stack([iq[s:s + n] for s in starts]).astype(np.complex64)


def _fold(tables, key):
    return tuple(torch.from_numpy(a) for a in tables[key])


def test_fold_demod_matches_jax(clean_frame):
    cfg, sps, iq, tables = clean_frame
    decim = cfg.decim_factor
    starts = [3 * sps + 17 + d for d in (-40, -3, 0, 5, 90, 200)]
    w2 = _windows(iq, starts, 2 * sps)
    fm = tables["fold_mat"]
    i_t = demod.upchirp_sync_parab(torch.from_numpy(w2), _fold(tables, "fold_mat"),
                                   sps, decim)
    i_j, _ = jdemod.upchirp_sync_parab(jnp.asarray(w2), tuple(map(jnp.asarray, fm)),
                                       sps, decim, xp=jnp)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))

    # every symbol window of the frame (preamble, sync, SFD, header, payload)
    sym = _windows(iq, range(3 * sps + 17, len(iq) - sps, sps), sps)
    b_t = demod.fft_shift_idx_mm(torch.from_numpy(sym), _fold(tables, "fold_mat"))
    b_j = jdemod.fft_shift_idx_mm(jnp.asarray(sym), tuple(map(jnp.asarray, fm)), xp=jnp)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))

    pc_t = demod.downchirp_pearson(torch.from_numpy(sym),
                                   torch.from_numpy(tables["down_ifreq"]), sps)
    pc_j = jdemod.downchirp_pearson(jnp.asarray(sym), tables["down_ifreq"], sps, xp=jnp)
    np.testing.assert_allclose(pc_t.numpy(), np.asarray(pc_j), atol=1e-5)

    lk_t = demod.upchirp_likeness_rows(torch.from_numpy(sym), b_t - 1,
                                       _fold(tables, "likeness_rows"))
    lk_j = jdemod.upchirp_likeness_rows(jnp.asarray(sym), b_j - 1,
                                        tables["likeness_rows"], xp=jnp)
    np.testing.assert_allclose(lk_t.numpy(), np.asarray(lk_j), atol=1e-5)


def test_cfo_matches_jax(clean_frame):
    cfg, sps, iq, tables = clean_frame
    p0 = 3 * sps + 17
    up = _windows(iq, [p0 + 2, p0 + sps], sps)
    sfd = _windows(iq, [p0 + 10 * sps, p0 + 11 * sps], sps)   # SFD downchirps
    x2 = _windows(iq, [p0 + 2, p0 + sps], 2 * sps)
    sr = cfg.samp_rate
    fm, fu = tables["fold_mat"], tables["fold_up"]
    frac_t = demod.preamble_cfo(torch.from_numpy(x2), sps, sr)
    frac_j = jdemod.preamble_cfo(jnp.asarray(x2), sps, sr, xp=jnp)
    np.testing.assert_allclose(frac_t.numpy(), np.asarray(frac_j), rtol=1e-4)
    co_t = demod.chirp_coarse_cfo(torch.from_numpy(up), torch.from_numpy(sfd),
                                  cfg.number_of_bins, sps, sr,
                                  _fold(tables, "fold_mat"), _fold(tables, "fold_up"))
    co_j = jdemod.chirp_coarse_cfo(jnp.asarray(up), jnp.asarray(sfd), None, None,
                                   cfg.number_of_bins, sps, sr, xp=jnp,
                                   fold_down=tuple(map(jnp.asarray, fm)),
                                   fold_up=tuple(map(jnp.asarray, fu)))
    np.testing.assert_array_equal(co_t.numpy(), np.asarray(co_j))
    cfo_t = demod.combine_cfo(co_t, frac_t, sps, sr)
    cfo_j = jdemod.combine_cfo(co_j, frac_j, sps, sr, xp=jnp)
    np.testing.assert_allclose(cfo_t.numpy(), np.asarray(cfo_j), rtol=1e-4)
    np.testing.assert_allclose(cfo_t.numpy(), 210.0, atol=5.0)


# ------------------------------------------------------- the last helpers
def test_gray_encode_equals_jax():
    from lora_tpu.ops import bits as jbits
    from lora_tpu_torch.ops import bits

    x = np.random.default_rng(3).integers(0, 1 << 12, (5, 97)).astype(np.int32)
    want = np.asarray(jbits.gray_encode(jnp.asarray(x), xp=jnp))
    np.testing.assert_array_equal(bits.gray_encode(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(bits.gray_encode(x), want)
    assert np.array_equal(bits.gray_decode(bits.gray_encode(x), 12), x)


@pytest.mark.parametrize("CW", [7, 28, 55, 256])
def test_decode_payload_equals_jax_and_lut(CW):
    """The unfused decode bit-equal to JAX's, and the fused table decode
    equal to it, for every CR, odd and even codeword counts and any
    ``n_valid`` (tests/test_ops.py's cases)."""
    rng = np.random.default_rng(42 + CW)
    lut = torch.from_numpy(dec.make_payload_nibble_lut(CW))
    cw = rng.integers(0, 1 << 12, size=(6, CW)).astype(np.int32)
    n_valid = rng.integers(0, CW + 1, size=6).astype(np.int32)
    for cr in range(5):
        crv = np.full(6, cr, np.int32)
        got = dec.decode_payload(torch.from_numpy(cw), torch.from_numpy(n_valid),
                                 torch.from_numpy(crv))
        want = jdec.decode_payload(jnp.asarray(cw), jnp.asarray(n_valid), jnp.asarray(crv),
                                   xp=jnp)
        assert got.dtype == torch.int32 and got.shape == (6, -(-CW // 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"cr {cr}")
        fused = dec.decode_payload_lut(torch.from_numpy(cw & 0xFF), torch.from_numpy(n_valid),
                                       torch.from_numpy(crv), lut)
        np.testing.assert_array_equal(fused.numpy(), got.numpy(), err_msg=f"lut, cr {cr}")


def test_instantaneous_phase_close_to_jax():
    """float32 rounding: the running sum of up to 300 steps of at most pi,
    summed in another order, within 1e-4 rad."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 300)) + 1j * rng.normal(size=(4, 300))).astype(np.complex64)
    got = chirp.instantaneous_phase(torch.from_numpy(x)).numpy()
    want = np.asarray(jchirp.instantaneous_phase(jnp.asarray(x), xp=jnp))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [512, 200])
def test_determine_cfo_dechirp_close_to_jax(clean_frame, n):
    """The CFO probe on the frame's windows, each ``n`` samples (200:
    shorter than the probe index, which then reads the last sample):
    within float32 rounding of the phase step, 1e-5 rad, in Hz."""
    cfg, sps, iq, tables = clean_frame
    w = _windows(iq, [3 * sps + 17 + k * sps for k in range(6)], 2 * sps)[..., :n]
    down = np.tile(tables["down"], 2)[:n]
    got = demod.determine_cfo_dechirp(torch.from_numpy(w), torch.from_numpy(down),
                                      cfg.samp_rate)
    want = jdemod.determine_cfo_dechirp(jnp.asarray(w), jnp.asarray(down), cfg.samp_rate,
                                        xp=jnp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 / (2 * np.pi) * cfg.samp_rate)
