"""The port's ``DenseReceiver.debug_trace`` against lora_tpu's.

Mirrors tests/test_debug_trace.py: the taps' shapes and meaning on both
engines, and the gradient engine's words and payload bins against the
golden receiver's ``DebugTrace`` (the port's golden copy). Then every key
against JAX's ``debug_trace`` on the same capture (SF7 CR4/8 at 1 Msps,
and an implicit-header and a ``low_snr`` receiver on the fft engine):
the same keys, shapes and dtypes; integer and boolean keys equal; float
keys (metrics, CFOs, Pearson scores, spectra) to rtol 1e-5, atol 1e-6
times the key's largest magnitude."""

import numpy as np
import pytest

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.rx.golden import GoldenReceiver

KW = dict(sf=7, cr=4, samp_rate=1e6, crc=True)
RX = dict(max_candidates=2, max_symbols=24)


@pytest.fixture(scope="module")
def capture():
    cfg = JConfig(**KW)
    return modulate_frame(cfg, b"\xde\xad\xbe\xef", pad_before=3000,
                          pad_after=2 * cfg.samples_per_symbol, snr_db=30.0, seed=5)


def assert_trace_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("method", ["gradient", "fft"])
def test_debug_trace_fields(capture, method):
    rx = DenseReceiver(LoRaConfig(**KW), **RX, demod_method=method, device="cpu")
    d = rx.debug_trace(capture)
    assert d["ok"].any()
    k = int(np.nonzero(d["ok"])[0][0])
    nsym = 8 + rx.S
    for key in ("words", "bins", "fine_syncs", "window_pos"):
        assert d[key].shape == (rx.P, nsym), key
    assert d["spectra"].shape[0:2] == (rx.P, nsym)
    assert d["sfd_corr"].shape == (rx.P, rx.F)
    # the SFD search saw upchirps (~ -1) then the downchirp (> 0.96)
    assert (d["sfd_corr"][k] < -0.9).any()
    assert d["payload"][k][:4].tobytes() == b"\xde\xad\xbe\xef"
    if method == "fft":
        # the folded spectra peak at the payload bins, before the
        # fft -> gradient convention shift
        peaks = d["spectra"][k].argmax(axis=-1)
        assert ((peaks[8:] - 1) % rx.n_bins == d["bins"][k][8:]).all()


def test_debug_trace_matches_golden(capture):
    g = GoldenReceiver(LoRaConfig(**KW), debug=True)
    assert g.run(capture)
    rx = DenseReceiver(LoRaConfig(**KW), **RX, demod_method="gradient", device="cpu")
    d = rx.debug_trace(capture)
    k = int(np.nonzero(d["ok"])[0][0])
    gw = np.asarray(g.debug.words)
    assert (d["words"][k][:len(gw)] == gw).all()
    gb = np.asarray(g.debug.bins)
    # golden logs the post-reduction bin of header symbols, the dense
    # engine the full-rate bin: the payload region compares exactly
    assert (d["bins"][k][8:len(gb)] == gb[8:]).all()


@pytest.mark.parametrize("method", ["gradient", "fft"])
def test_debug_trace_matches_jax(capture, method):
    rx = DenseReceiver(LoRaConfig(**KW), **RX, demod_method=method, device="cpu")
    jrx = JDenseReceiver(JConfig(**KW), **RX, demod_method=method)
    assert_trace_equal(rx.debug_trace(capture), jrx.debug_trace(capture))


@pytest.mark.parametrize("mode", ["implicit", "low_snr"])
def test_debug_trace_modes_match_jax(mode):
    """The implicit energy stop and the coherent SFD's taps (its
    ``sfd_corr`` is the up/down fold-peak contrast), at 250 ksps."""
    kw = dict(sf=7, cr=4, samp_rate=250e3, crc=mode != "implicit",
              implicit=mode == "implicit")
    extra = {"low_snr": True} if mode == "low_snr" else {"demod_method": "fft"}
    cfg = JConfig(**kw)
    x = modulate_frame(cfg, b"\x5a\xa5\x01", pad_before=2000,
                       pad_after=4 * cfg.samples_per_symbol,
                       snr_db=0.0 if mode == "low_snr" else 30.0, seed=2)
    rx = DenseReceiver(LoRaConfig(**kw), **RX, **extra, device="cpu")
    d = rx.debug_trace(x)
    assert_trace_equal(d, JDenseReceiver(cfg, **RX, **extra).debug_trace(x))
    assert d["ok"].any()
