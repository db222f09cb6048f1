"""The port's coherent low-SNR mode against lora_tpu's.

Mirrors tests/test_low_snr.py but for its SF12 case, which runs on the
card (tests/test_torch_cuda.py, chip_smoke.py). ``DenseReceiver(low_snr=
True)`` detects by the dechirp-fold peak/mean and finds the SFD by the up-
and down-dechirped fold peaks. The decode-rate gates are the JAX tests'.
Held to JAX on the same captures, stacked into one block so that each
receiver sees them in one call: ``DenseResult`` fields bit-equal for
valid lanes, ``snr`` rtol 1e-5, ``cfo`` 1 Hz (tests/test_torch_dense.py);
the dechirp metric's score and energies rtol 1e-5, atol 1e-6 times the
largest value; frames of the wideband receiver and the gateways equal."""

import numpy as np
import pytest
import torch

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.rx.frontend import detection_metrics_dechirp as jdechirp
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.rx import frontend

from test_torch_dense import assert_same

PAYLOAD = bytes.fromhex("deadbeef")
KW = dict(sf=7, cr=4, samp_rate=250e3, crc=True)
RX = dict(max_candidates=8, max_symbols=24, sfd_search=12)


def _captures(snr_db, n=6, cfo_hz=0.0):
    """``n`` captures of one packet each (tests/test_low_snr.py's), zero-
    padded to one length and stacked ``[n, L]``."""
    cfg = JConfig(**KW)
    sps = cfg.samples_per_symbol
    xs = [modulate_frame(cfg, PAYLOAD, pad_before=2500 + 137 * k, pad_after=3 * sps,
                         snr_db=snr_db, cfo_hz=cfo_hz, seed=k) for k in range(n)]
    L = max(len(x) for x in xs)
    return np.stack([np.pad(x, (0, L - len(x))) for x in xs]).astype(np.complex64)


def _rate(rx, xs):
    return sum(any(f.mac_payload == PAYLOAD for f in rx.run(x)) for x in xs) / len(xs)


def _port(**kw):
    return DenseReceiver(LoRaConfig(**KW), **RX, **kw, device="cpu")


def _jax(**kw):
    return JDenseReceiver(JConfig(**KW), **RX, **kw)


def test_dechirp_metric_matches_jax():
    xs = _captures(-4.0, n=2)
    rx = _port(low_snr=True)
    xf = np.stack([xs.real, xs.imag], axis=-2).astype(np.float32)
    got = frontend.detection_metrics_dechirp(torch.from_numpy(xf), rx.sps, rx._fold_mat)
    want = jdechirp(xf, rx.sps, tuple(t.numpy() for t in rx._fold_mat))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def test_sf7_decodes_at_minus4db():
    rx = _port(low_snr=True)
    assert rx.method == "fft" and rx.low_snr
    assert rx.low_snr_threshold == pytest.approx(1.6 * (np.log(128) + 0.5772))
    xs = _captures(-4.0)
    assert _rate(rx, xs) == 1.0
    assert_same(rx.process(xs), jax.device_get(_jax(low_snr=True).process(xs)),
                n_expected=len(xs))


def test_sf7_low_snr_with_cfo():
    """The dechirp sync absorbs CFO into timing (self-consistent for the
    fft demod), so a moderate CFO survives at low SNR."""
    xs = _captures(0.0, cfo_hz=500.0)
    rx = _port(low_snr=True)
    assert _rate(rx, xs) >= 5 / 6
    assert_same(rx.process(xs), jax.device_get(_jax(low_snr=True).process(xs)))


def test_parity_chain_fails_where_low_snr_decodes():
    """The reference-parity gates lose the packets the coherent mode
    decodes, in both packages."""
    xs = _captures(-4.0)
    rx = _port(demod_method="fft")
    assert _rate(rx, xs) == 0.0
    assert_same(rx.process(xs), jax.device_get(_jax(demod_method="fft").process(xs)),
                n_expected=0)


def test_noise_only_emits_nothing():
    rx = _port(low_snr=True)
    sps = rx.sps
    rng = np.random.default_rng(5)
    xs = (rng.normal(size=(8, 60 * sps))
          + 1j * rng.normal(size=(8, 60 * sps))).astype(np.complex64)
    assert all(rx.run(x) == [] for x in xs)
    assert_same(rx.process(xs), jax.device_get(_jax(low_snr=True).process(xs)),
                n_expected=0)


def test_low_snr_guards():
    with pytest.raises(ValueError, match="fft engine"):
        _port(demod_method="gradient", low_snr=True)
    with pytest.raises(ValueError, match="explicit-header"):
        DenseReceiver(LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=False, implicit=True),
                      low_snr=True, device="cpu")
    # past the 64M-entry fold budget (SF12 at 1 Msps: 32768 x 4096)
    with pytest.raises(ValueError, match="fold-DFT"):
        DenseReceiver(LoRaConfig(sf=12, cr=4, samp_rate=1e6, crc=True, reduced_rate=True),
                      low_snr=True, device="cpu")


def test_low_snr_threshold_and_conj_match_jax():
    """A downlink (``conj``) capture dechirps with the upchirp; a lower
    threshold admits more candidates; both as JAX's."""
    kw = dict(KW, conj=True)
    cfg = JConfig(**kw)
    x = modulate_frame(cfg, PAYLOAD, pad_before=3000, pad_after=3 * cfg.samples_per_symbol,
                       snr_db=-2.0, seed=9)
    rx = DenseReceiver(LoRaConfig(**kw), **RX, low_snr=True, low_snr_threshold=5.0,
                       device="cpu")
    jrx = JDenseReceiver(cfg, **RX, low_snr=True, low_snr_threshold=5.0)
    assert rx.low_snr_threshold == 5.0
    assert_same(rx.process(x), jax.device_get(jrx.process(x)), n_expected=1)


def test_wideband_low_snr_passthrough():
    """WidebandReceiver forwards low_snr to its dense stage: a noisy packet
    on one PFB channel decodes through the PFB and the coherent detection,
    with JAX's frames."""
    from lora_tpu.channelizer import pfb_channel_freqs
    from lora_tpu.wideband import WidebandReceiver as JWidebandReceiver
    from lora_tpu_torch import WidebandReceiver

    M = 8
    kw = dict(max_candidates=4, max_symbols=24, sfd_search=12, low_snr=True)
    wr = WidebandReceiver(LoRaConfig(**KW), M, device="cpu", **kw)
    assert wr.rx.low_snr
    wide_rate = M * KW["samp_rate"]
    sps = JConfig(**KW).samples_per_symbol
    L = M * 64 * sps
    rng = np.random.default_rng(0)
    x = (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(np.complex64) * 0.5
    pkt = modulate_frame(JConfig(**dict(KW, samp_rate=wide_rate)), PAYLOAD, snr_db=None)
    c, pos = 3, 6 * sps * M
    t = np.arange(len(pkt))
    x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * pfb_channel_freqs(wide_rate, M)[c]
                                           / wide_rate * (t + pos))).astype(np.complex64)
    frames = wr.run(x)
    assert any(f.channel == c and f.mac_payload == PAYLOAD for f in frames)
    want = JWidebandReceiver(JConfig(**KW), M, **kw).run(x)
    assert [(f.channel, f.payload, f.sample_index) for f in frames] == \
        [(f.channel, f.payload, f.sample_index) for f in want]


def test_gateways_skip_shared_detection_with_low_snr(monkeypatch):
    """A gateway bank with a low_snr receiver runs each SF's own (dechirp)
    detection, never the shared multi-lag pass, and decodes as JAX's."""
    from lora_tpu import plans as jplans
    from lora_tpu_torch import plans
    from lora_tpu_torch import MultiSFWidebandReceiver, PlanGateway

    def refuse(*a, **k):
        raise AssertionError("shared detection ran for a low_snr bank")

    monkeypatch.setattr(plans, "multi_sf_detection_metrics", refuse)
    center, rate = 867.3e6, 1e6
    cfg = JConfig(sf=7, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
    pkt = modulate_frame(cfg, PAYLOAD, snr_db=0.0, seed=3)
    L = 40 * 4 * cfg.samples_per_symbol
    rng = np.random.default_rng(2)
    x = (0.05 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    pos = 5000
    t = np.arange(len(pkt)) + pos
    x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * 0.2e6 / rate * t)).astype(np.complex64)
    kw = dict(sfs=(7, 8), pool=4, max_candidates=2, max_symbols=16, low_snr=True)
    gw = PlanGateway("EU868", center, rate, device="cpu", **kw)
    got = gw.run(x)
    want = jplans.PlanGateway("EU868", center, rate, **kw).run(x)
    assert any(f.mac_payload == PAYLOAD and f.tap_header.sf == 7 for f in got)
    assert [(f.channel, f.tap_header.sf, f.payload, f.sample_index) for f in got] == \
        [(f.channel, f.tap_header.sf, f.payload, f.sample_index) for f in want]

    from lora_tpu_torch import wideband

    monkeypatch.setattr(wideband, "multi_sf_detection_metrics", refuse)
    mg = MultiSFWidebandReceiver(LoRaConfig(**KW), 4, sfs=(7, 8), pool=4,
                                 max_candidates=2, max_symbols=16, low_snr=True,
                                 device="cpu")
    assert mg.shared_detection
    mg.process(np.zeros(4 * 40 * 1024, np.complex64))
