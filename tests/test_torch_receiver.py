"""The port's receiver facade (``LoRaReceiver``) against lora_tpu's.

Each capture goes through both facades, the port's on the CPU. JAX
channelizes one channel in host numpy and several on its device with a
float32 phase ramp; the port channelizes both on its device, with the
mixer phase built in float64 on the host. So the channel streams agree to
float32 rounding (one channel: rtol 1e-5, atol 1e-6 times the stream's
largest magnitude, checked here) or to JAX's float32 ramp (several
channels, ~1e-2 rad at the end of these captures). Frames are held equal
in header bytes, payload, channel, sample index and tap header; ``snr``
to rtol 1e-4 and ``cfo`` to 2 Hz (the streams' rounding, through the
energy ratio and the phase estimate). The dense engine's complex-input
cores (``process_complex``, ``process_pooled``) are held to JAX's as
tests/test_pooled.py:64 and tests/test_overflow.py:47 drive them. The
golden engine runs at the channel rate of 1 Msps (decimation 8 against
the bandwidth), the gradient demod's regime: at 250 ksps a one-sample
timing error is half a bin, and the reference model misreads symbols
there in both packages alike."""

import numpy as np
import pytest
import torch

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.channelizer import fractional_resampler as jresampler
from lora_tpu.channelizer import freq_xlating_fir as jxlating
from lora_tpu.receiver import LoRaReceiver as JLoRaReceiver
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import DenseReceiver, LoRaConfig, LoRaReceiver
from lora_tpu_torch.channelizer import freq_xlating_fir, lora_channel_taps

DEADBEEF = bytes.fromhex("deadbeef")
CENTER = 868.1e6


def capture(rate, placements, L, seed=0, noise=1e-3):
    """Noise of ``noise`` a part and packets ``(offset Hz, payload, pos,
    cfo Hz)`` at SF7 CR4/8, mixed to their offsets from the center."""
    rng = np.random.default_rng(seed)
    x = (noise * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    cfg = JConfig(sf=7, cr=4, samp_rate=rate, crc=True)
    for i, (off, payload, pos, cfo) in enumerate(placements):
        pkt = modulate_frame(cfg, payload, cfo_hz=cfo, snr_db=None, seed=i)
        t = np.arange(pos, pos + len(pkt), dtype=np.float64)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * off / rate * t)).astype(np.complex64)
    return x


def same_frames(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.phy_header.to_bytes(), g.payload, g.channel, g.sample_index) == \
            (w.phy_header.to_bytes(), w.payload, w.channel, w.sample_index)
        assert g.tap_header.to_bytes()[:12] == w.tap_header.to_bytes()[:12]
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=2.0)


def facades(engine, **kw):
    base = dict(samp_rate=1e6, center_freq=CENTER, bandwidth=125e3, sf=7, cr=4, crc=True,
                engine=engine)
    base.update(kw)
    return LoRaReceiver(device="cpu", **base), JLoRaReceiver(**base)


def test_one_channel_stream_matches_jax():
    x = capture(1e6, [(200e3, DEADBEEF, 5000, 0.0)], 120_000)
    taps = lora_channel_taps(1e6, 125e3)
    for D in (1, 4):
        got = freq_xlating_fir(x, taps, 200e3, 1e6, D, device="cpu").numpy()
        want = jxlating(x, taps, 200e3, 1e6, D)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("engine", ["golden", "dense"])
def test_one_channel_matches_jax(engine):
    x = capture(1e6, [(200e3, DEADBEEF, 5000, 150.0), (200e3, b"\x01\x02", 70_000, -80.0)],
                140_000)
    kw = dict(channel_list=[CENTER + 200e3], decimation=1)
    if engine == "dense":
        kw.update(decimation=4, max_candidates=4, max_symbols=24)
    rx, jrx = facades(engine, **kw)
    got = rx.receive(x)
    same_frames(got, jrx.receive(x))
    assert [f.mac_payload for f in got] == [DEADBEEF, b"\x01\x02"]
    assert all(f.tap_header.frequency == int(CENTER + 200e3) and f.tap_header.sf == 7
               for f in got)


@pytest.mark.parametrize("engine", ["golden", "dense"])
def test_three_channels_match_jax(engine):
    offs = (-300e3, 0.0, 250e3)
    x = capture(1e6, [(offs[0], b"\xa0", 3000, 0.0), (offs[1], b"\xb1\xb2", 20_000, 0.0),
                      (offs[2], DEADBEEF, 9000, 0.0)], 100_000, seed=3)
    kw = dict(channel_list=[CENTER + o for o in offs], decimation=1)
    if engine == "dense":
        kw.update(decimation=4, max_candidates=2, max_symbols=24)
    rx, jrx = facades(engine, **kw)
    got = rx.receive(x)
    same_frames(got, jrx.receive(x))
    assert {f.channel: f.mac_payload for f in got} == {0: b"\xa0", 1: b"\xb1\xb2",
                                                       2: DEADBEEF}


def test_auto_cfo_feedback_matches_jax():
    """tests/test_cfo.py: the median frame CFO retunes the mixer."""
    cfg = JConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    sps = cfg.samples_per_symbol
    pkt = modulate_frame(cfg, b"\x11", pad_before=8 * sps, pad_after=8 * sps,
                         snr_db=40.0, cfo_hz=-400.0)
    kw = dict(samp_rate=250e3, channel_list=[CENTER], disable_channelization=True,
              auto_cfo=True, max_candidates=2, max_symbols=16, sfd_search=12)
    rx, jrx = facades("dense", **kw)
    same_frames(rx.receive(pkt), jrx.receive(pkt))
    assert abs(rx._cfo - (-400.0)) < 20.0
    assert rx._cfo == pytest.approx(jrx._cfo, abs=1.0)
    rx.apply_cfo(10.0)
    assert rx._cfo == pytest.approx(jrx._cfo + 10.0, abs=1.0)


def test_low_snr_auto_two_pass_policy():
    """tests/test_low_snr.py: the parity gates first; only an empty capture
    builds the coherent receiver, which recovers it. Implicit configs
    never retry."""
    cfg = JConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    sps = cfg.samples_per_symbol
    kw = dict(samp_rate=250e3, channel_list=[CENTER], disable_channelization=True,
              low_snr="auto", max_candidates=8, max_symbols=24, sfd_search=12)
    strong, jstrong = facades("dense", **kw)
    x = modulate_frame(cfg, DEADBEEF, pad_before=2500, pad_after=3 * sps, snr_db=30.0, seed=1)
    same_frames(strong.receive(x), jstrong.receive(x))
    assert strong._coherent is None
    weak, jweak = facades("dense", **kw)
    x = modulate_frame(cfg, DEADBEEF, pad_before=2500, pad_after=3 * sps, snr_db=-4.0, seed=2)
    frames = weak.receive(x)
    assert any(f.mac_payload == DEADBEEF for f in frames)
    same_frames(frames, jweak.receive(x))
    assert weak._coherent is not None and weak._coherent.low_snr
    implicit, _ = facades("dense", **dict(kw, implicit=True, max_candidates=4))
    x = modulate_frame(JConfig(sf=7, cr=4, samp_rate=250e3, crc=True, implicit=True),
                       DEADBEEF, pad_before=2500, pad_after=1024, snr_db=-4.0, seed=3)
    assert implicit.receive(x) == [] and implicit._coherent is None


def test_fractional_decimation_matches_jax():
    """tests/test_fractional_resampler.py: a 1.024 Msps capture through the
    fractional resampler (host numpy, bit-equal) into the golden engine."""
    from lora_tpu_torch.channelizer import fractional_resampler

    tx = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    pkt_1m = modulate_frame(tx, DEADBEEF, pad_before=4000, pad_after=2048, snr_db=30.0, seed=3)
    pkt = jresampler(pkt_1m, 1.0 / 1.024)
    np.testing.assert_array_equal(fractional_resampler(pkt_1m, 1.0 / 1.024), pkt)
    kw = dict(samp_rate=1.024e6, channel_list=[CENTER], decimation=1.024,
              disable_channelization=True)
    rx, jrx = facades("golden", **kw)
    got = rx.receive(pkt)
    same_frames(got, jrx.receive(pkt))
    assert [f.mac_payload for f in got] == [DEADBEEF]
    with pytest.raises(ValueError, match="fractional"):
        LoRaReceiver(samp_rate=1.024e6, center_freq=CENTER, channel_list=[CENTER],
                     bandwidth=125e3, sf=7, decimation=1.024, device="cpu")


def test_engines_and_device():
    from lora_tpu_torch.rx.receiver import ParityReceiver

    par = LoRaReceiver(1e6, CENTER, [CENTER], 125e3, 7, engine="parity", device="cpu",
                       max_frames=4)
    dec = par._make_decoder()
    assert isinstance(dec, ParityReceiver)
    assert (dec.device.type, dec.max_frames) == ("cpu", 4)
    with pytest.raises(ValueError, match="engine"):
        LoRaReceiver(1e6, CENTER, [CENTER], 125e3, 7, engine="nope", device="cpu")
    if torch.cuda.is_available():
        assert LoRaReceiver(1e6, CENTER, [CENTER], 125e3, 7).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LoRaReceiver(1e6, CENTER, [CENTER], 125e3, 7)
    rx = LoRaReceiver(1e6, CENTER, [CENTER], 125e3, 9, device="cpu")
    assert (rx.get_sf(), rx.get_center_freq()) == (9, CENTER)
    rx.set_center_freq(868.3e6)
    assert rx.get_center_freq() == 868.3e6
    with pytest.warns(UserWarning):
        rx.set_sf(8)


RATE = 250e3


def test_process_pooled_direct_multichannel_matches_jax():
    """tests/test_pooled.py:64: process_pooled on a plain [C, L] channel
    batch, the caller giving the tailroom."""
    cfg = JConfig(sf=7, cr=4, samp_rate=RATE, crc=True)
    sps = cfg.samples_per_symbol
    rows = [modulate_frame(cfg, bytes([c]), pad_before=(4 + c) * sps, pad_after=4 * sps,
                           snr_db=40.0, seed=c) for c in range(4)]
    L = -(-max(len(r) for r in rows) // sps) * sps
    xs = np.stack([np.pad(r, (0, L - len(r))) for r in rows])
    kw = dict(max_candidates=2, max_symbols=16, sfd_search=12)
    rx = DenseReceiver(LoRaConfig(sf=7, cr=4, samp_rate=RATE, crc=True), **kw, device="cpu")
    jrx = JDenseReceiver(cfg, **kw)
    xs = np.pad(xs, ((0, 0), (0, rx.pkt_samples))).astype(np.complex64)
    got = rx.process_pooled(torch.from_numpy(xs), pool=6)
    want = jax.device_get(jax.jit(lambda xc: jrx.process_pooled(xc, pool=6))(xs))
    valid = np.asarray(want.valid)
    assert {int(got.channel[g]): bytes(got.payload[g][:1].numpy())
            for g in np.nonzero(got.valid.numpy())[0]} == {c: bytes([c]) for c in range(4)}
    for f in ("valid", "channel", "start", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("payload", "length", "hdr"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid])
    np.testing.assert_allclose(got.snr.numpy()[valid], np.asarray(want.snr)[valid], rtol=1e-5)


def test_process_complex_and_pool_overflow_match_jax():
    """tests/test_overflow.py:47: six packets into a pool of four, two
    dropped and counted; and process_complex on the same rows, with a
    downlink config conjugating its input."""
    cfg = JConfig(sf=7, cr=4, samp_rate=RATE, crc=True)
    sps = cfg.samples_per_symbol

    def stream(n, seed):
        return np.concatenate([modulate_frame(cfg, bytes([seed, k]), pad_before=3 * sps,
                                              pad_after=2 * sps, snr_db=35.0, seed=seed + k)
                               for k in range(n)])

    kw = dict(max_candidates=4, max_symbols=24, demod_method="fft")
    rx = DenseReceiver(LoRaConfig(sf=7, cr=4, samp_rate=RATE, crc=True), **kw, device="cpu")
    jrx = JDenseReceiver(cfg, **kw)
    a, b = stream(3, 1), stream(3, 2)
    n = max(len(a), len(b)) + rx.pkt_samples
    x = np.stack([np.pad(a, (0, n - len(a))), np.pad(b, (0, n - len(b)))]).astype(np.complex64)
    got = rx.process_pooled(torch.from_numpy(x), pool=4, per_channel=4)
    want = jax.jit(lambda xc: jrx.process_pooled(xc, pool=4, per_channel=4))(x)
    assert int(got.valid.sum()) == 4 and int(got.n_dropped) == 2
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.start.numpy(), np.asarray(want.start))
    np.testing.assert_array_equal(got.n_dropped.numpy(), np.asarray(want.n_dropped))

    from test_torch_dense import assert_same

    want = jax.device_get(jax.jit(jrx.process_complex)(x))
    assert_same(rx.process_complex(torch.from_numpy(x)), want, n_expected=6)
    # the complex tensor's host form: process pads it by pkt_samples
    assert_same(rx.process(torch.from_numpy(x)), jax.device_get(jrx.process(x)),
                n_expected=6)
    kwc = dict(sf=7, cr=4, samp_rate=RATE, crc=True, conj=True)
    rxc = DenseReceiver(LoRaConfig(**kwc), **kw, device="cpu")
    jrxc = JDenseReceiver(JConfig(**kwc), **kw)
    xc = np.conj(x)
    assert_same(rxc.process_complex(torch.from_numpy(xc)),
                jax.device_get(jax.jit(jrxc.process_complex)(xc)), n_expected=6)
