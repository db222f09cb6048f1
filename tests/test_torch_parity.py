"""The port's parity engine (``rx/receiver.ParityReceiver``) against JAX's
``JaxReceiver`` and the port's golden engine.

Each stream goes through JAX's compiled loop and the port's loop on the
CPU. Frames are held equal in payload, header bytes, channel and sample
index, with ``snr`` to rtol 1e-4 (the power queue's float32 sums in
another order move its last bits); where the whole final state is
compared, integer fields are equal and float fields within rtol 1e-4,
for the same reason. The golden engine decides the same frames (payload
and header). The inputs: the seven configurations of
tests/test_jax_receivers.py, a four-frame stream, the frame ring's
overflow (tests/test_overflow.py:63), sync word 0x12 at SF7 and SF12
(tests/test_sync_word.py:42), a 60 ppm drifting capture (the PAUSE
feed-forward), SF6 implicit, and an implicit capture whose signal runs
past the demod buffer's 544 codewords (the clamped append); a
three-channel batch against three single runs; the two detection
reductions against JAX's, zero-energy windows included."""

import numpy as np
import pytest
import torch

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.channelizer import fractional_resampler
from lora_tpu.ops import demod as jdemod
from lora_tpu.ops import xfer
from lora_tpu.rx.receiver import JaxReceiver
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import LoRaConfig
from lora_tpu_torch.ops import demod
from lora_tpu_torch.rx.golden import GoldenReceiver
from lora_tpu_torch.rx.receiver import DECODE_PAYLOAD, MAX_CODEWORDS, ParityReceiver

DEADBEEF = bytes.fromhex("deadbeef")


def make_stream(cfg, payload=DEADBEEF, n=1, seed=0, **kw):
    """tests/test_jax_receivers.py's stream: ``n`` frames, 40 dB."""
    sps = cfg.samples_per_symbol
    one = modulate_frame(cfg, payload, pad_before=2500, pad_after=2 * sps, snr_db=40.0,
                         seed=seed, **kw)
    return np.concatenate([one] * n + [np.zeros(3 * sps, np.complex64)])


def configs(**kw):
    return JConfig(**kw), LoRaConfig(**kw)


def same_frames(got, want, snr=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.payload, g.phy_header.to_bytes(), g.channel, g.sample_index) == \
            (w.payload, w.phy_header.to_bytes(), w.channel, w.sample_index)
        if snr:
            assert g.snr == pytest.approx(w.snr, rel=1e-4)


def same_decisions(got, gold):
    assert [(f.mac_payload, f.phy_header.to_bytes()) for f in got] == \
        [(f.mac_payload, f.phy_header.to_bytes()) for f in gold]


def same_state(jrx, prx, x):
    """JAX's final loop state against the port's, field by field; returns
    the port's."""
    js = jax.device_get(jrx._run(xfer.pack_iq(x.astype(np.complex64))))
    ps = prx.process_complex(torch.from_numpy(x.astype(np.complex64))[None])
    for k in js._fields:
        got = ps[k][0].numpy()
        want = np.asarray(getattr(js, k)).reshape(got.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=k)
    return ps


@pytest.mark.parametrize(
    "kw",
    [
        dict(sf=7, cr=4),
        dict(sf=7, cr=1),
        dict(sf=8, cr=3),
        dict(sf=11, cr=4, reduced_rate=True),
        dict(sf=7, cr=4, implicit=True),
        dict(sf=7, cr=4, conj=True),
        dict(sf=7, cr=4, disable_drift_correction=True),
    ],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()),
)
def test_state_machine_matches_jax_and_golden(kw):
    jcfg, cfg = configs(samp_rate=1e6, crc=True, **kw)
    x = make_stream(jcfg)
    jrx = JaxReceiver(jcfg)
    prx = ParityReceiver(cfg, device="cpu")
    got = prx.run(x)
    same_frames(got, jrx.run(x))
    same_decisions(got, GoldenReceiver(cfg).run(x))
    assert [f.mac_payload for f in got] == [DEADBEEF]
    same_state(jrx, prx, x)


def test_four_frames_match_jax():
    jcfg, cfg = configs(sf=7, cr=4, samp_rate=1e6, crc=True)
    x = make_stream(jcfg, n=4)
    prx = ParityReceiver(cfg, device="cpu")
    got = prx.run(x)
    same_frames(got, JaxReceiver(jcfg).run(x))
    same_decisions(got, GoldenReceiver(cfg).run(x))
    assert len(got) == 4 and prx.n_dropped == 0
    assert prx.state_reads == prx.steps + 1 and prx.steps > 4 * 40


def _overflow_stream(jcfg, n_packets: int, seed: int = 0):
    """tests/test_overflow.py's stream."""
    rng = np.random.default_rng(seed)
    chunks = [modulate_frame(jcfg, DEADBEEF, pad_before=int(rng.integers(2500, 3500)),
                             pad_after=jcfg.samples_per_symbol, snr_db=40.0,
                             seed=int(rng.integers(0, 2**31)))
              for _ in range(n_packets)]
    chunks.append(np.zeros(4 * jcfg.samples_per_symbol, np.complex64))
    return np.concatenate(chunks)


@pytest.mark.parametrize("max_frames", [2, 8])
def test_frame_ring_overflow_matches_jax(max_frames):
    jcfg, cfg = configs(sf=7, cr=4, samp_rate=1e6, crc=True)
    x = _overflow_stream(jcfg, 4)
    jrx = JaxReceiver(jcfg, max_frames=max_frames)
    prx = ParityReceiver(cfg, max_frames=max_frames, device="cpu")
    got = prx.run(x)
    same_frames(got, jrx.run(x))
    assert (len(got), prx.n_dropped) == (min(4, max_frames), jrx.n_dropped)
    assert prx.n_dropped == max(4 - max_frames, 0)


@pytest.mark.parametrize("sf", [7, 12])
def test_sync_word_0x12_matches_jax(sf):
    jcfg, cfg = configs(sf=sf, cr=4, samp_rate=1e6, crc=True, reduced_rate=sf > 10,
                        sync_word=0x12)
    sps = jcfg.samples_per_symbol
    chunk = modulate_frame(jcfg, DEADBEEF, pad_before=2500, pad_after=sps, snr_db=40.0, seed=0)
    x = np.concatenate([chunk, np.zeros(3 * sps, np.complex64)])
    got = ParityReceiver(cfg, device="cpu").run(x)
    same_frames(got, JaxReceiver(jcfg).run(x))
    assert [f.mac_payload for f in got] == [DEADBEEF]


def test_drift_feed_forward_matches_jax():
    """A 60 ppm sample-clock offset at SF9: the SFD walk's fine-sync
    corrections give a nonzero drift rate, which PAUSE feeds forward
    across the blind SFD region and the drift step applies a symbol."""
    jcfg, cfg = configs(sf=9, cr=4, samp_rate=1e6, crc=True)
    sps = jcfg.samples_per_symbol
    chunk = modulate_frame(jcfg, DEADBEEF + b"\x01\x02", pad_before=2500, pad_after=sps,
                           snr_db=40.0, seed=0)
    chunk = fractional_resampler(chunk, 1.0 + 60e-6).astype(np.complex64)
    x = np.concatenate([chunk, np.zeros(3 * sps, np.complex64)])
    jrx = JaxReceiver(jcfg)
    prx = ParityReceiver(cfg, device="cpu")
    got = prx.run(x)
    same_frames(got, jrx.run(x))
    assert [f.mac_payload for f in got] == [DEADBEEF + b"\x01\x02"]
    st = same_state(jrx, prx, x)
    assert int(st["drift_den"][0]) > 0 and round(2.25 * float(st["drift_num"][0])
                                                 / int(st["drift_den"][0])) != 0


def test_sf6_implicit_matches_jax():
    jcfg, cfg = configs(sf=6, cr=4, samp_rate=1e6, crc=True, implicit=True)
    x = make_stream(jcfg, n=2)
    jrx = JaxReceiver(jcfg)
    prx = ParityReceiver(cfg, device="cpu")
    got = prx.run(x)
    same_frames(got, jrx.run(x))
    assert [f.payload[:4] for f in got] == [DEADBEEF] * 2
    same_state(jrx, prx, x)


def clamp_capture(cfg, n_noise_symbols: int = 700, tail: bool = True):
    """An implicit SF7 frame followed by noise of the signal's power: the
    energy stop never fires, so the payload demod appends past the demod
    buffer's end and JAX clamps the rows onto its last slot."""
    sps = cfg.samples_per_symbol
    pkt = modulate_frame(cfg, DEADBEEF, pad_before=2500, snr_db=None, seed=0)
    rng = np.random.default_rng(0)
    L = n_noise_symbols * sps
    noise = (rng.normal(size=L) + 1j * rng.normal(size=L)).astype(np.complex64)
    parts = [pkt, noise] + ([np.zeros(3 * sps, np.complex64)] if tail else [])
    return np.concatenate(parts)


def test_demod_buffer_clamp_matches_jax():
    """With the stream ending inside the noise the loop stops in
    DECODE_PAYLOAD with a full buffer: every codeword, the clamped last
    slot included, equals JAX's. With silence after it, the energy stop
    emits one 260-byte frame, equal to JAX's."""
    jcfg, cfg = configs(sf=7, cr=4, samp_rate=1e6, crc=True, implicit=True)
    jrx = JaxReceiver(jcfg)
    prx = ParityReceiver(cfg, device="cpu")
    st = same_state(jrx, prx, clamp_capture(jcfg, tail=False))
    assert int(st["state"][0]) == DECODE_PAYLOAD and int(st["n_demod"][0]) == MAX_CODEWORDS
    assert int(st["demod_buf"][0, -1]) != 0
    x = clamp_capture(jcfg)
    got = prx.run(x)
    same_frames(got, jrx.run(x))
    assert len(got) == 1 and len(got[0].payload) == 260


def test_three_channel_batch_equals_single_runs():
    """One batched loop over three streams of one length: each channel's
    frames equal its own run's and JAX's, in channel order."""
    jcfg, cfg = configs(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = jcfg.samples_per_symbol
    streams = [make_stream(jcfg, payload=bytes([0xA0 + c]) + DEADBEEF, n=1 + c, seed=c)
               for c in range(3)]
    L = max(len(s) for s in streams) + 7 * sps
    streams = np.stack([np.pad(np.roll(s, 1000 * c), (0, L - len(s)))
                        for c, s in enumerate(streams)])
    prx = ParityReceiver(cfg, device="cpu")
    got = prx.run_batch(streams)
    want = []
    jrx = JaxReceiver(jcfg)
    for c in range(3):
        one = prx.run(streams[c])
        for f in one:
            f.channel = c
        want.extend(one)
        jf = jrx.run(streams[c])
        for f in jf:
            f.channel = c
        same_frames(one, jf)
    same_frames(got, want)
    assert [(f.channel, f.mac_payload[0]) for f in got] == \
        [(c, 0xA0 + c) for c in range(3) for _ in range(1 + c)]
    planes = np.stack([np.stack([s.real, s.imag]) for s in streams]).astype(np.float32)
    same_frames(prx.run_batch(torch.from_numpy(planes)), want)


@pytest.mark.parametrize("sf", [7, 12])
def test_detection_reductions_match_jax(sf):
    """``preamble_autocorr`` and ``symbol_energy`` of noise, chirp and
    zero-energy windows at SF7 and SF12 (1 Msps), against JAX's."""
    jcfg = JConfig(sf=sf, cr=4, samp_rate=1e6, crc=True)
    sps = jcfg.samples_per_symbol
    rng = np.random.default_rng(sf)
    pkt = modulate_frame(jcfg, DEADBEEF, pad_before=0, snr_db=20.0, seed=1)[:4 * sps]
    w = np.zeros((6, 2 * sps), np.complex64)
    w[0] = (rng.normal(size=2 * sps) + 1j * rng.normal(size=2 * sps))
    w[1] = pkt[:2 * sps]
    w[2] = pkt[sps // 3:sps // 3 + 2 * sps]
    w[3, :sps] = pkt[:sps]                       # second symbol zero
    w[4, sps:] = pkt[:sps]                       # first symbol zero
    # w[5]: all zero
    got = demod.preamble_autocorr(torch.from_numpy(w), sps)
    want = jdemod.preamble_autocorr(jax.numpy.asarray(w), sps, xp=jax.numpy)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    assert got[0][1] > 0.9 and float(got[0][3]) == float(got[0][4]) == float(got[0][5]) == 0.0
    e = demod.symbol_energy(torch.from_numpy(w[:, :sps]))
    np.testing.assert_allclose(e.numpy(), np.asarray(jdemod.symbol_energy(
        jax.numpy.asarray(w[:, :sps]), xp=jax.numpy)), rtol=1e-5)
    assert float(e[4]) == float(e[5]) == 0.0


def facade_capture(offsets, L, seed=3):
    """Noise of 1e-3 a part and SF7 CR4/8 packets at 1 Msps on each channel
    ``offsets`` (Hz from the center), as tests/test_torch_receiver.py
    builds its captures."""
    jcfg = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    rng = np.random.default_rng(seed)
    x = (1e-3 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    for c, off in enumerate(offsets):
        pkt = modulate_frame(jcfg, bytes([0xB0 + c]) + DEADBEEF, snr_db=None, seed=c)
        pos = 3000 + 17_000 * c
        t = np.arange(pos, pos + len(pkt), dtype=np.float64)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * off / 1e6 * t)).astype(np.complex64)
    return x


@pytest.mark.parametrize("offsets", [(200e3,), (-300e3, 0.0, 250e3)], ids=["1ch", "3ch"])
def test_facade_parity_matches_jax(offsets):
    """``LoRaReceiver(engine="parity")`` against JAX's facade: JAX decodes
    each channel with its own run, the port the three in one batched loop;
    the frames and their order are equal, and equal to the port's golden
    facade's. One channel: snr to rtol 1e-4 (the channel streams agree to
    float32 rounding). Three channels: JAX's mixer ramps its phase in
    float32 (the port's is built in float64), so the streams differ by
    that ramp's error and the snr (a ratio to a noise-only window's power)
    by up to ~0.5 %; the port's snr is held to rtol 1e-4 of JAX's
    ``JaxReceiver`` run on the port's own channel streams instead."""
    from lora_tpu.receiver import LoRaReceiver as JLoRaReceiver

    from lora_tpu_torch import LoRaReceiver

    center = 868.1e6
    kw = dict(samp_rate=1e6, center_freq=center, channel_list=[center + o for o in offsets],
              bandwidth=125e3, sf=7, cr=4, crc=True)
    x = facade_capture(offsets, 40_000 + 17_000 * len(offsets))
    rx = LoRaReceiver(engine="parity", device="cpu", **kw)
    got = rx.receive(x)
    want = JLoRaReceiver(engine="parity", **kw).receive(x)
    same_frames(got, want, snr=len(offsets) == 1)
    assert [(f.channel, f.mac_payload) for f in got] == \
        [(c, bytes([0xB0 + c]) + DEADBEEF) for c in range(len(offsets))]
    if len(offsets) > 1:
        jrx = JaxReceiver(JConfig(sf=7, cr=4, samp_rate=1e6, crc=True))
        on_ours = []
        for c, s in enumerate(rx._channelize(x).numpy()):
            for f in jrx.run(s):
                f.channel = c
                on_ours.append(f)
        same_frames(got, on_ours)
    gold = LoRaReceiver(engine="golden", device="cpu", **kw).receive(x)
    assert [(f.channel, f.sample_index, f.payload) for f in got] == \
        [(f.channel, f.sample_index, f.payload) for f in gold]


def test_run_suite_parity_matches_jax(tmp_path):
    """``run_suite(engine="parity")`` and the ``testsuite --engine parity``
    command on a mini suite (SF7, CR 4/8 and 4/5, explicit and implicit)
    against JAX's runner: the same accuracies and the same report, its
    backend stamp the device's type."""
    from lora_tpu import testsuite as jts

    from lora_tpu_torch import cli, testsuite

    suites = tmp_path / "suites"
    for suite in ("mini", "mini_implicit"):
        testsuite.generate_suite(str(suites), suite, sfs=(7,), crs=(4, 1), samp_rate=1e6)
    names = ("mini", "mini_implicit")
    got = testsuite.run_suite(str(suites), names, reports_path=str(tmp_path / "port"),
                              engine="parity", report_suffix="_parity", device="cpu")
    want = jts.run_suite(str(suites), names, reports_path=str(tmp_path / "jax"),
                         engine="parity", report_suffix="_parity")
    assert got == want == {"mini": 1.0, "mini_implicit": 1.0}
    def report(d, name):
        lines = (tmp_path / d / f"{name}_parity.md").read_text().splitlines()
        return [line for line in lines if not line.startswith("*Results on")]

    for name in names:
        assert "*Backend: cpu*" in report("port", name)
        assert report("port", name) == report("jax", name)
    assert cli.main(["testsuite", str(suites), "mini", "--engine", "parity", "--device", "cpu",
                     "--reports", str(tmp_path / "cmd"), "--min-accuracy", "1.0"]) == 0
    assert report("cmd", "mini") == report("port", "mini")
