"""The port's no-fold demod ops and fft drift pass against lora_tpu's, on
the CPU.

The ops run at SF7 and SF9 at 250 ksps (decim 2) on windows of a noisy
frame with a carrier offset, against their JAX forms with ``xp=jnp``:
integer bins and sync offsets bit-equal, the parabolic fraction within
1e-5 bins, folded magnitudes within 1e-5 of the spectrum's peak and the
likeness within 1e-5 (ifreq from atan2, whose last bit differs between
XLA's and torch's CPU implementations). The median helper is held to
``jnp.median`` bit for bit. End to end, the SF12 / 250 ksps receiver
(no fold matrices, drift pass on) decodes tests/test_fft_drift.py's
+-30 ppm streams into the frames JAX gives, field by field (snr rtol
1e-5, cfo atol 1 Hz), and fails without the drift pass as JAX does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.ops import demod as jdemod
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.convert import load_tables
from lora_tpu_torch.ops import demod
from lora_tpu_torch.rx.dense import build_tables

from test_fft_drift import PAYLOAD, _stream
from test_torch_ops import jax_tables

SF12 = dict(sf=12, cr=4, samp_rate=250e3, crc=True, reduced_rate=True)


@pytest.fixture(scope="module", params=[7, 9], ids=["sf7", "sf9"])
def frame(request):
    """A noisy frame at 250 ksps with a 230 Hz carrier offset, the port's
    tables (equal to lora_tpu's: test_torch_ops.py) and the sample where
    its preamble starts."""
    sf = request.param
    kw = dict(sf=sf, cr=4, samp_rate=250e3, crc=True)
    cfg = LoRaConfig(**kw)
    sps = cfg.samples_per_symbol
    p0 = 3 * sps + 17
    iq = jmodulate(JConfig(**kw), b"\xde\xad\xbe\xef", pad_before=p0, cfo_hz=230.0,
                   snr_db=None)
    rng = np.random.default_rng(sf)
    iq = (iq + 0.05 * (rng.normal(size=len(iq)) + 1j * rng.normal(size=len(iq))))
    return cfg, sps, iq.astype(np.complex64), build_tables(cfg, 24), p0


def _windows(iq, starts, n):
    return np.stack([iq[s:s + n] for s in starts]).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _symbols(iq, p0, sps):
    return _windows(iq, range(p0 - sps // 3, len(iq) - sps, sps // 2), sps)


def test_dechirp_fft_and_shift_idx_match_jax(frame):
    cfg, sps, iq, tables, p0 = frame
    nb = cfg.number_of_bins
    sym = _symbols(iq, p0, sps)
    for chirp in ("down", "up"):
        mag_t = demod.dechirp_fft_mag(_t(sym), _t(tables[chirp]), nb, sps)
        mag_j = jdemod.dechirp_fft_mag(jnp.asarray(sym), tables[chirp], nb, sps, xp=jnp)
        assert mag_t.shape == (len(sym), nb)
        np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), rtol=0,
                                   atol=1e-5 * float(np.abs(mag_j).max()))
        b_t = demod.fft_shift_idx(_t(sym), _t(tables[chirp]), nb, sps)
        b_j = jdemod.fft_shift_idx(jnp.asarray(sym), tables[chirp], nb, sps, xp=jnp)
        assert b_t.dtype == torch.int32
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("fold", [False, True], ids=["magnitude", "fold-power"])
def test_fft_shift_frac_matches_jax(frame, fold):
    cfg, sps, iq, tables, p0 = frame
    nb = cfg.number_of_bins
    sym = _symbols(iq, p0, sps)
    fm = tables["fold_mat"] if fold else None
    b_t, f_t = demod.fft_shift_frac(_t(sym), _t(tables["down"]), nb, sps,
                                    fold_mat=None if fm is None else tuple(map(_t, fm)))
    b_j, f_j = jdemod.fft_shift_frac(jnp.asarray(sym), tables["down"], nb, sps, xp=jnp,
                                     fold_mat=None if fm is None else tuple(map(jnp.asarray, fm)))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    assert f_t.dtype == torch.float32 and bool((f_t.abs() < 0.5).all())
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0, atol=1e-5)


def test_sync_coarse_fine_matches_jax(frame):
    cfg, sps, iq, tables, p0 = frame
    decim, nb = cfg.decim_factor, cfg.number_of_bins
    w2 = _windows(iq, [p0 + d for d in (-40, -3, 0, 1, 5, 90, 200, sps - 7)], 2 * sps)
    got = demod.upchirp_sync_coarse_fine(_t(w2), _t(tables["down"]), _t(tables["up_ifreq"]),
                                         sps, nb, decim)
    want, _ = jdemod.upchirp_sync_coarse_fine(jnp.asarray(w2), tables["down"],
                                              tables["up_ifreq"], sps, nb, decim, xp=jnp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upchirp_likeness_matches_jax(frame):
    cfg, sps, iq, tables, p0 = frame
    decim, nb = cfg.decim_factor, cfg.number_of_bins
    sym = _symbols(iq, p0, sps)[None]                          # [1, F, sps]
    bins = demod.fft_shift_idx(_t(sym), _t(tables["down"]), nb, sps) - 1
    got = demod.upchirp_likeness(_t(sym), bins, _t(tables["up_ifreq_v"]), sps, decim)
    want = jdemod.upchirp_likeness(jnp.asarray(sym), jnp.asarray(bins.numpy()),
                                   tables["up_ifreq_v"], sps, decim, xp=jnp)
    assert got.shape == bins.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(got.max()) > 0.9                               # the preamble upchirps


def test_coarse_cfo_without_fold_matches_jax(frame):
    cfg, sps, iq, tables, p0 = frame
    nb, sr = cfg.number_of_bins, cfg.samp_rate
    up = _windows(iq, [p0 + 2, p0 + sps, p0 + 3 * sps - 1], sps)
    sfd = _windows(iq, [p0 + 10 * sps, p0 + 11 * sps, p0 + 10 * sps + 3], sps)
    got = demod.chirp_coarse_cfo(_t(up), _t(sfd), nb, sps, sr, None, None,
                                 _t(tables["up"]), _t(tables["down"]))
    want = jdemod.chirp_coarse_cfo(jnp.asarray(up), jnp.asarray(sfd), tables["up"],
                                   tables["down"], nb, sps, sr, xp=jnp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [12, 11, 8])
def test_median_matches_jnp_median(n):
    rng = np.random.default_rng(n)
    d = rng.normal(size=(64, n)).astype(np.float32)
    d[0, : n // 2] = d[0, 0]           # ties across the middle
    got = demod.median(torch.from_numpy(d))
    want = np.asarray(jnp.median(jnp.asarray(d), axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    if n % 2 == 0:                     # torch.median keeps the lower middle value
        assert not torch.equal(got, torch.from_numpy(d).median(dim=-1).values)


def test_tables_leave_out_fold_above_budget():
    cfg = LoRaConfig(**SF12)
    tables = build_tables(cfg, 48)
    assert tables["fold_mat"] is None and tables["fold_up"] is None
    assert tables["likeness_rows"] is None
    rx = DenseReceiver(cfg, max_candidates=4, max_symbols=48, device="cpu")
    assert rx._fold_mat is None and rx._likeness_rows is None and rx.fft_drift_pass


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.phy_header.to_bytes(), g.payload, g.channel, g.sample_index) == \
            (w.phy_header.to_bytes(), w.payload, w.channel, w.sample_index)
        assert g.snr == pytest.approx(w.snr, rel=1e-5)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


@pytest.mark.parametrize("tables", ["own", "loaded"])
@pytest.mark.parametrize("ppm", [-30.0, 30.0])
def test_drift_pass_sf12_matches_jax(ppm, tables):
    """The no-fold SF12 receiver with its drift pass: the +-30 ppm stream
    decodes to JAX's frames, with the port's tables or JAX's loaded."""
    stream = _stream(JConfig(**SF12), ppm)
    kw = dict(max_candidates=4, max_symbols=48, demod_method="fft")
    jrx = JDenseReceiver(JConfig(**SF12), **kw, fft_drift_pass=True)
    want = jrx.run(stream)
    rx = DenseReceiver(LoRaConfig(**SF12), **kw, device="cpu")   # drift pass: auto-on
    if tables == "loaded":
        load_tables(rx, jax_tables(jrx))
    got = rx.run(stream)
    assert len(got) == 1 and got[0].mac_payload == PAYLOAD
    _assert_frames_equal(got, want)


def test_sf13_no_fold_matches_jax():
    """SF13 at 250 ksps (sps * n_bins = 128M: no fold matrices, the
    dechirp FFT and table slices; the drift pass on): a clean packet
    decodes to JAX's frame."""
    kw = dict(sf=13, cr=4, samp_rate=250e3, crc=True, reduced_rate=True)
    stream = _stream(JConfig(**kw), 0.0)
    rx_kw = dict(max_candidates=2, max_symbols=24, demod_method="fft")
    rx = DenseReceiver(LoRaConfig(**kw), **rx_kw, device="cpu")
    assert rx._fold_mat is None and rx.fft_drift_pass
    got = rx.run(stream)
    assert [f.mac_payload for f in got] == [PAYLOAD]
    _assert_frames_equal(got, JDenseReceiver(JConfig(**kw), **rx_kw).run(stream))


def test_sf12_without_drift_pass_fails_as_jax():
    stream = _stream(JConfig(**SF12), 30.0)
    kw = dict(max_candidates=4, max_symbols=48, demod_method="fft", fft_drift_pass=False)
    want = JDenseReceiver(JConfig(**SF12), **kw).run(stream)
    got = DenseReceiver(LoRaConfig(**SF12), **kw, device="cpu").run(stream)
    assert not any(f.mac_payload == PAYLOAD for f in got)
    _assert_frames_equal(got, want)


def test_drift_pass_on_the_fold_path_matches_jax():
    """SF11 at 250 ksps keeps its fold matrices (8M entries): the drift
    pass takes the vertex of the folded power there."""
    kw = dict(sf=11, cr=4, samp_rate=250e3, crc=True, reduced_rate=True)
    stream = _stream(JConfig(**kw), -30.0, seed=1)
    rx_kw = dict(max_candidates=2, max_symbols=40, demod_method="fft")
    want = JDenseReceiver(JConfig(**kw), **rx_kw).run(stream)
    rx = DenseReceiver(LoRaConfig(**kw), **rx_kw, device="cpu")
    assert rx.fft_drift_pass and rx._fold_mat is not None
    got = rx.run(stream)
    assert len(got) == 1 and got[0].mac_payload == PAYLOAD
    _assert_frames_equal(got, want)


@pytest.mark.parametrize("sf,on", [(7, False), (10, False), (11, True), (12, True)])
def test_drift_pass_auto_policy(sf, on):
    kw = dict(sf=sf, cr=4, samp_rate=250e3, crc=True, reduced_rate=sf >= 11)
    assert DenseReceiver(LoRaConfig(**kw), demod_method="fft", max_symbols=16,
                         device="cpu").fft_drift_pass is on
    assert JDenseReceiver(JConfig(**kw), demod_method="fft",
                          max_symbols=16).fft_drift_pass is on
    assert DenseReceiver(LoRaConfig(**kw), fft_drift_pass=not on, max_symbols=16,
                         device="cpu").fft_drift_pass is (not on)


def test_drift_pass_clean_sf7_unchanged():
    """Zero drift: the corrected reads decode as the static grid does."""
    kw = dict(sf=7, cr=4, samp_rate=250e3, crc=True)
    stream = _stream(JConfig(**kw), 0.0)
    frames = [DenseReceiver(LoRaConfig(**kw), max_candidates=4, max_symbols=24,
                            fft_drift_pass=p, device="cpu").run(stream) for p in (False, True)]
    want = JDenseReceiver(JConfig(**kw), max_candidates=4, max_symbols=24,
                          demod_method="fft", fft_drift_pass=True).run(stream)
    assert [f.mac_payload for f in frames[1]] == [PAYLOAD]
    _assert_frames_equal(frames[1], frames[0])
    _assert_frames_equal(frames[1], want)
