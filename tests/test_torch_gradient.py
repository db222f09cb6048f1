"""The port's gradient engine against lora_tpu's, on the CPU.

The ops (``upchirp_sync_grad``, ``upchirp_sync_xcorr``,
``max_frequency_gradient_idx``, ``fine_sync_lag``) run on windows of a
noisy frame with a carrier offset at SF7 and SF9 at 1 Msps (decim 8),
against their JAX forms with ``xp=jnp``: integer outputs bit-equal, the
sliding search's maximum rtol 1e-5 (float32 sums in another order).

End to end, ``DenseReceiver(demod_method="gradient")`` (and ``"auto"``,
which resolves to it at decim >= 4 with explicit headers) decodes small
SF7-SF9 captures at 1 Msps, one with a 30 ppm sample-clock offset, into
the results JAX's receiver gives: equal ``valid`` masks and starts; for
valid lanes bit-equal payload, length and header; snr rtol 1e-5, cfo atol
1 Hz (as tests/test_torch_dense.py). Blocks stay at or under 512 symbols:
JAX's CPU compile of the engine grows with them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.channelizer import fractional_resampler
from lora_tpu.ops import chirp as jchirp
from lora_tpu.ops import demod as jdemod
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.convert import load_tables
from lora_tpu_torch.ops import demod

from test_torch_dense import assert_same
from test_torch_ops import jax_tables


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[7, 9], ids=["sf7", "sf9"])
def windows(request):
    """Two-symbol windows at assorted offsets into a noisy 1 Msps frame
    with a 310 Hz carrier offset, and the config's reference tables."""
    sf = request.param
    cfg = JConfig(sf=sf, cr=4, samp_rate=1e6, crc=True)
    sps = cfg.samples_per_symbol
    iq = jmodulate(cfg, b"\xde\xad\xbe\xef\x01\x02", pad_before=sps // 3, cfo_hz=310.0,
                   snr_db=12.0, seed=sf)
    rng = np.random.default_rng(sf)
    offs = rng.integers(0, len(iq) - 2 * sps, 24)
    w2 = np.stack([iq[o:o + 2 * sps] for o in offs]).astype(np.complex64)
    up, _ = jchirp.build_ideal_chirps(cfg)
    return cfg, w2, jchirp.instantaneous_frequency(up), jchirp.tiled_upchirp_ifreq(cfg)


def test_upchirp_sync_grad_matches_jax(windows):
    cfg, w2, up_ifreq, _ = windows
    args = (cfg.samples_per_symbol, cfg.number_of_bins, cfg.decim_factor)
    want = jdemod.upchirp_sync_grad(jnp.asarray(w2), up_ifreq, *args, xp=jnp)[0]
    got = demod.upchirp_sync_grad(_t(w2), _t(up_ifreq), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upchirp_sync_xcorr_matches_jax(windows):
    cfg, w2, up_ifreq, _ = windows
    sps = cfg.samples_per_symbol
    w_idx, w_max = jdemod.upchirp_sync_xcorr(jnp.asarray(w2), up_ifreq, sps, xp=jnp)
    idx, mx = demod.upchirp_sync_xcorr(_t(w2), _t(up_ifreq), sps)
    assert idx.dtype == torch.int32 and mx.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(mx.numpy(), np.asarray(w_max), rtol=1e-5)


def test_max_frequency_gradient_idx_matches_jax(windows):
    cfg, w2, _, _ = windows
    sps = cfg.samples_per_symbol
    # symbol windows at every quarter-symbol step, and the decim <= 2
    # branch (no tail trim) on the same windows
    w = np.concatenate([w2[:, :sps], w2[:, sps // 4:sps // 4 + sps]])
    for decim in (cfg.decim_factor, 2):
        nb = sps // decim
        want = jdemod.max_frequency_gradient_idx(jnp.asarray(w), nb, decim, xp=jnp)
        got = demod.max_frequency_gradient_idx(_t(w), nb, decim)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fine_sync_lag_matches_jax(windows):
    cfg, w2, _, tiled = windows
    sps, nb, decim = cfg.samples_per_symbol, cfg.number_of_bins, cfg.decim_factor
    w = w2[:, :sps]
    bins = np.asarray(jdemod.max_frequency_gradient_idx(jnp.asarray(w), nb, decim, xp=jnp))
    ss = demod.fine_sync_search_space(decim)
    assert ss == jdemod.fine_sync_search_space(decim) == 2
    for b, space in ((bins, ss), (np.full(len(w), -1, np.int32), 4 * decim),
                     (np.full(len(w), nb - 1, np.int32), ss)):
        want = jdemod.fine_sync_lag(jnp.asarray(w), jnp.asarray(b), tiled, sps, decim, space,
                                    xp=jnp)
        got = demod.fine_sync_lag(_t(w), _t(b), _t(tiled), sps, decim, space)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a Python int bin serves every lane, as the SFD walk's -1 does
    np.testing.assert_array_equal(
        demod.fine_sync_lag(_t(w), -1, _t(tiled), sps, decim, 4 * decim).numpy(),
        demod.fine_sync_lag(_t(w), _t(np.full(len(w), -1)), _t(tiled), sps, decim,
                            4 * decim).numpy())


def test_fine_sync_search_space():
    for decim in (1, 2, 4, 8, 16, 32):
        assert demod.fine_sync_search_space(decim) == jdemod.fine_sync_search_space(decim)


# (channel, symbol offset, extra samples, payload, cfo Hz, sync word)
PACKETS = [
    (0, 4, 37, b"\xde\xad\xbe\xef", 0.0, 0x00),
    (0, 90, 501, b"hello", -230.0, 0x34),
    (1, 30, 3, bytes(range(7)), 310.0, 0x12),
    (1, 150, 777, b"\x00", 120.0, 0x00),
]
RX = dict(max_candidates=3, max_symbols=24, sfd_search=12)


def make_block(kw, n_sym, ppm=0.0, seed=7):
    """Two channels of ``n_sym`` symbols of low noise with the packets of
    ``PACKETS`` that fit, each resampled by ``1 + ppm * 1e-6`` (a
    transmitter clock offset). Returns the block and the packet count."""
    cfg = JConfig(**kw)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(seed)
    x = 0.003 * (rng.normal(size=(2, n_sym * sps)) + 1j * rng.normal(size=(2, n_sym * sps)))
    x = x.astype(np.complex64)
    n = 0
    for c, sym, extra, payload, cfo, sw in PACKETS:
        pkt = jmodulate(cfg.replace(sync_word=sw), payload, cfo_hz=cfo, snr_db=30.0, seed=sym)
        if ppm:
            pkt = fractional_resampler(pkt, 1.0 + ppm * 1e-6).astype(np.complex64)
        s0 = sym * sps + extra
        if s0 + len(pkt) + (RX["sfd_search"] + 13 + RX["max_symbols"]) * sps > x.shape[-1]:
            continue
        x[c, s0:s0 + len(pkt)] += pkt
        n += 1
    return x, n


# (config, symbols in the block, clock offset ppm)
CASES = {
    "sf7": (dict(sf=7, cr=4, samp_rate=1e6, crc=True), 240, 0.0),
    "sf8-30ppm": (dict(sf=8, cr=2, samp_rate=1e6, crc=True), 200, 30.0),
    "sf9": (dict(sf=9, cr=1, samp_rate=1e6, crc=True), 120, 0.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, n_sym, ppm = CASES[request.param]
    x, n = make_block(kw, n_sym, ppm)
    jrx = JDenseReceiver(JConfig(**kw), demod_method="gradient", **RX)
    return kw, x, n, jrx, jax.device_get(jrx.process(x))


def test_gradient_engine_matches_jax(case):
    kw, x, n, jrx, want = case
    assert n >= 2
    rx = DenseReceiver(LoRaConfig(**kw), demod_method="gradient", **RX, device="cpu")
    assert rx.method == "gradient" and rx.fast_sync and not rx.fft_drift_pass
    assert_same(rx.process(x), want, n_expected=n)


def test_auto_engine_matches_jax(case):
    kw, x, n, jrx, want = case
    rx = DenseReceiver(LoRaConfig(**kw), **RX, device="cpu")     # default: "auto"
    assert rx.method == "gradient"
    load_tables(rx, jax_tables(jrx))
    assert_same(rx.process(x), want, n_expected=n)


def test_gradient_run_and_pooled_match_jax(case):
    kw, x, n, jrx, _ = case
    rx = DenseReceiver(LoRaConfig(**kw), demod_method="gradient", **RX, device="cpu")
    want = jrx.run(x)
    got = rx.run(x)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert (g.phy_header.to_bytes(), g.payload, g.channel, g.sample_index) == \
            (w.phy_header.to_bytes(), w.payload, w.channel, w.sample_index)
        assert g.crc_ok is True
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)
    pad = np.pad(x, [(0, 0), (0, rx.pkt_samples)])
    xf = np.stack([pad.real, pad.imag], axis=-2).astype(np.float32)
    w_pool = jax.device_get(jrx.process_pooled_planes(jnp.asarray(xf), pool=4,
                                                      per_channel=3))
    g_pool = rx.process_pooled_planes(torch.from_numpy(xf), pool=4, per_channel=3)
    valid = np.asarray(w_pool.valid)
    np.testing.assert_array_equal(g_pool.valid.numpy(), valid)
    np.testing.assert_array_equal(g_pool.channel.numpy(), np.asarray(w_pool.channel))
    np.testing.assert_array_equal(g_pool.start.numpy(), np.asarray(w_pool.start))
    for f in ("payload", "length", "hdr"):
        np.testing.assert_array_equal(getattr(g_pool, f).numpy()[valid],
                                      np.asarray(getattr(w_pool, f))[valid])


def test_reference_sliding_sync_matches_jax():
    kw, n_sym, _ = CASES["sf7"]
    x, n = make_block(kw, n_sym)
    jrx = JDenseReceiver(JConfig(**kw), demod_method="gradient", fast_sync=False, **RX)
    rx = DenseReceiver(LoRaConfig(**kw), demod_method="gradient", fast_sync=False, **RX,
                       device="cpu")
    assert not rx.fast_sync
    assert_same(rx.process(x), jax.device_get(jrx.process(x)), n_expected=n)


def test_drift_correction_off_matches_jax():
    kw = dict(CASES["sf7"][0], disable_drift_correction=True)
    x, n = make_block(kw, CASES["sf7"][1])
    jrx = JDenseReceiver(JConfig(**kw), demod_method="gradient", **RX)
    rx = DenseReceiver(LoRaConfig(**kw), demod_method="gradient", **RX, device="cpu")
    assert_same(rx.process(x), jax.device_get(jrx.process(x)), n_expected=n)


def test_engine_selection():
    sf7 = dict(sf=7, cr=4, crc=True)
    assert DenseReceiver(LoRaConfig(**sf7, samp_rate=1e6), device="cpu").method == "gradient"
    assert DenseReceiver(LoRaConfig(**sf7, samp_rate=250e3), device="cpu").method == "fft"
    with pytest.raises(ValueError, match="demod_method"):
        DenseReceiver(LoRaConfig(**sf7, samp_rate=1e6), demod_method="nope", device="cpu")
    with pytest.raises(NotImplementedError):
        DenseReceiver(LoRaConfig(**sf7, samp_rate=1e6), device="cpu").debug_trace(None)
