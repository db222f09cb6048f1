"""The port's golden receiver against lora_tpu's: tx -> golden rx.

Mirrors tests/test_golden_roundtrip.py's fast set (the canonical SF7
demo config and one case per feature axis; its slow SF x CR matrix is
the suites' work). Each capture goes through both golden receivers, and
the frames must be equal in every field the receivers set, as both are
numpy running the same float32 arithmetic: header bytes, payload,
sample index, SNR (exactly), and with ``debug`` the per-symbol bins,
words, fine syncs and correlations. Ground truth as in the JAX tests."""

import numpy as np
import pytest

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.rx.golden import GoldenReceiver as JGolden
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import LoRaConfig
from lora_tpu_torch.io.frames import PhyHeader
from lora_tpu_torch.rx import golden_ops
from lora_tpu_torch.rx.golden import GoldenReceiver

DEADBEEF = bytes.fromhex("deadbeef")


def both(kw, stream):
    g = GoldenReceiver(LoRaConfig(**kw), debug=True)
    j = JGolden(JConfig(**kw), debug=True)
    got, want = g.run(stream), j.run(stream)
    assert [(f.phy_header.to_bytes(), f.payload, f.sample_index, f.snr) for f in got] == \
        [(f.phy_header.to_bytes(), f.payload, f.sample_index, f.snr) for f in want]
    for key in ("bins", "words", "fine_syncs", "detect_corrs", "sfd_corrs", "sfd_walk"):
        assert getattr(g.debug, key) == getattr(j.debug, key), key
    return got


def roundtrip(kw, payload, snr_db=40.0, cfo_hz=0.0, seed=0):
    cfg = JConfig(**kw)
    stream = modulate_frame(cfg, payload, pad_before=3000,
                            pad_after=3 * cfg.samples_per_symbol,
                            snr_db=snr_db, cfo_hz=cfo_hz, seed=seed)
    return both(kw, stream)


SF7 = dict(sf=7, cr=4, samp_rate=1e6, crc=True)


def test_demo_config_sf7():
    """The reference install check: SF7 CR4/8 BW125 @1Msps, deadbeef,
    header bytes 04 90 40."""
    frames = roundtrip(SF7, DEADBEEF)
    assert len(frames) == 1
    assert frames[0].mac_payload == DEADBEEF
    assert frames[0].phy_header.to_bytes() == b"\x04\x90\x40"


def test_multiple_frames_in_stream():
    cfg = JConfig(**SF7)
    sps = cfg.samples_per_symbol
    one = modulate_frame(cfg, DEADBEEF, pad_before=2000, pad_after=2000)
    stream = np.concatenate([one] * 5 + [np.zeros(3 * sps, np.complex64)])
    rng = np.random.default_rng(0)
    noise = (rng.normal(0, 1e-3, (len(stream), 2)) @ np.array([1, 1j])).astype(np.complex64)
    frames = both(SF7, stream + noise)
    assert [f.mac_payload for f in frames] == [DEADBEEF] * 5


@pytest.mark.parametrize("kw", [
    dict(SF7, cr=1), dict(SF7, cr=2), dict(SF7, cr=3),
    dict(sf=11, cr=4, samp_rate=1e6, crc=True, reduced_rate=True),
    dict(SF7, implicit=True), dict(SF7, conj=True),
    dict(SF7, disable_drift_correction=True), dict(SF7, crc=False),
], ids=["cr1", "cr2", "cr3", "sf11-reduced", "implicit", "conj", "no-drift", "no-crc"])
def test_feature_axes(kw):
    frames = roundtrip(kw, DEADBEEF)
    assert len(frames) == 1 and frames[0].mac_payload == DEADBEEF
    if not kw["crc"]:
        assert frames[0].payload == DEADBEEF


def test_cfo_tolerance():
    for cfo in (200.0, -300.0):
        frames = roundtrip(SF7, DEADBEEF, cfo_hz=cfo)
        assert len(frames) == 1 and frames[0].mac_payload == DEADBEEF


def test_sf6_implicit():
    with pytest.raises(ValueError):
        LoRaConfig(sf=6, cr=4, samp_rate=1e6, crc=True)
    frames = roundtrip(dict(sf=6, cr=4, samp_rate=1e6, crc=True, implicit=True), DEADBEEF)
    assert len(frames) == 1 and frames[0].mac_payload.startswith(DEADBEEF)


def test_garbage_header_cr0_does_not_crash():
    """A garbage header with cr=0 decodes to no bytes; the golden
    receiver drops sync instead of reading past them, as JAX's does."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    g = GoldenReceiver(cfg)
    g.phdr = PhyHeader(cr=0, has_mac_crc=0)
    pkt = modulate_frame(JConfig(sf=7, cr=4, samp_rate=250e3, crc=True), b"\xde\xad",
                         pad_before=2048, pad_after=2048, snr_db=40.0)
    assert isinstance(g.run(np.asarray(pkt)), list)


def test_numpy_helpers_match_jax_numpy_path():
    """The golden's numpy window DSP against lora_tpu.ops.demod with
    ``xp=np``: bit-equal."""
    from lora_tpu.ops import chirp as jchirp
    from lora_tpu.ops import demod as jdemod

    cfg = JConfig(sf=8, cr=4, samp_rate=1e6, crc=True)
    sps, nb, decim = cfg.samples_per_symbol, cfg.number_of_bins, cfg.decim_factor
    x = modulate_frame(cfg, DEADBEEF, pad_before=sps // 3, snr_db=10.0, cfo_hz=150.0, seed=3)
    offs = np.random.default_rng(1).integers(0, len(x) - 2 * sps, 16)
    w2 = np.stack([x[o:o + 2 * sps] for o in offs])
    up, down = jchirp.build_ideal_chirps(cfg)
    up_if, down_if = jchirp.instantaneous_frequency(up), jchirp.instantaneous_frequency(down)
    tiled = jchirp.tiled_upchirp_ifreq(cfg)
    w = w2[:, :sps]
    b = golden_ops.max_frequency_gradient_idx(w, nb, decim)
    pairs = [
        (golden_ops.preamble_autocorr(w2, sps), jdemod.preamble_autocorr(w2, sps)),
        (golden_ops.symbol_energy(w), jdemod.symbol_energy(w)),
        (golden_ops.upchirp_sync_xcorr(w2, up_if, sps), jdemod.upchirp_sync_xcorr(w2, up_if, sps)),
        (golden_ops.downchirp_pearson(w, down_if, sps), jdemod.downchirp_pearson(w, down_if, sps)),
        (golden_ops.upchirp_likeness(w, b, tiled, sps, decim),
         jdemod.upchirp_likeness(w, b, tiled, sps, decim)),
        (b, jdemod.max_frequency_gradient_idx(w, nb, decim)),
        (golden_ops.fine_sync_lag(w, b, tiled, sps, decim, 2),
         jdemod.fine_sync_lag(w, b, tiled, sps, decim, 2)),
    ]
    for got, want in pairs:
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, wv in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, wv)
