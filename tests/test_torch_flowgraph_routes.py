"""The channelizer routes of the port's flowgraph receiver blocks against
``lora_tpu.flowgraph``'s, on the CPU (``device="cpu"``), on the same
captures: the polyphase filterbank route of a dense channel grid
(tests/test_flowgraph_wideband.py), the mixer-bank route off the grid
(tests/test_dev_channelizer.py), the ``lora_gateway`` block on a PFB grid
and on the EU868 plan (tests/test_flowgraph_gateway.py), and the CFO loop
(tests/test_cfo_stream.py). Frames are held equal in payload, header
bytes, channel, sample index and tap header, ``snr`` to rtol 1e-4 and
``cfo`` within 2 Hz; the mixer bank's channel streams to JAX's device
bank at float32 rounding (rtol 1e-5, atol 1e-6 of the largest magnitude:
the same float64 tables, the FIR's sums in another order)."""

import numpy as np
import pytest

from lora_tpu import flowgraph as jfg
from lora_tpu.channelizer import pfb_channel_freqs
from lora_tpu.config import LoRaConfig as JConfig
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import Flowgraph
from lora_tpu_torch import flowgraph as fg

M = 16
CHAN_RATE = 250e3
SAMP_RATE = M * CHAN_RATE
CENTER = 868.0e6


def same_frames(got, want, key=None):
    if key is not None:
        got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.payload, g.phy_header.to_bytes(), g.channel, g.sample_index,
                g.tap_header.to_bytes()[:12]) == \
            (w.payload, w.phy_header.to_bytes(), w.channel, w.sample_index,
             w.tap_header.to_bytes()[:12])
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=2.0)


def pump(rx, x, chunk):
    frames = []
    for i in range(0, len(x), chunk):
        frames += rx.push(x[i:i + chunk])
    frames += rx.flush()
    rx.close()
    return frames


def test_channel_grid_takes_the_pfb_route():
    """Three channels on the samp_rate/M grid (one at a negative offset),
    decimation M: the polyphase filterbank in the wideband streamer."""
    spacing = SAMP_RATE / M
    chans = [CENTER + 1 * spacing, CENTER + 5 * spacing, CENTER - 2 * spacing]
    kw = dict(samp_rate=SAMP_RATE, center_freq=CENTER, channel_list=chans, sf=7, cr=4,
              crc=True, engine="dense", decimation=M, block_symbols=128, max_candidates=2,
              max_symbols=24)
    rx = fg.StreamingLoRaReceiver(device="cpu", **kw)
    jrx = jfg.StreamingLoRaReceiver(**kw)
    assert rx.route == "pfb" and jrx._wb_stream is not None
    wide_cfg = JConfig(sf=7, cr=4, samp_rate=SAMP_RATE, crc=True)
    sps_w = wide_cfg.samples_per_symbol
    payloads = {0: b"\x0a\x0b", 1: b"\x1c", 2: b"\x2d\x2e\x2f"}
    L = rx._wb_stream.block_len + rx._wb_stream.hop
    x = np.zeros(L, np.complex64)
    for ci, payload in payloads.items():
        pkt = modulate_frame(wide_cfg, payload, snr_db=None)
        pos = (4 + 40 * ci) * sps_w
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (chans[ci] - CENTER) / SAMP_RATE
                                               * t)).astype(np.complex64)
    got = pump(rx, x, 300_000)
    same_frames(got, pump(jrx, x, 300_000))
    assert {f.channel: f.payload[:len(payloads[f.channel])] for f in got} == payloads
    assert all(f.tap_header.frequency == int(chans[f.channel]) for f in got)


def test_off_grid_takes_the_mixer_bank():
    kw = dict(samp_rate=SAMP_RATE, center_freq=CENTER, channel_list=[CENTER + 100e3] * 9,
              sf=7, cr=4, crc=True, engine="dense", decimation=M, block_symbols=128,
              max_candidates=2, max_symbols=24)
    rx = fg.StreamingLoRaReceiver(device="cpu", **kw)
    assert rx.route == "mixer_bank" and rx._wb_stream is None and rx._streams is not None
    one = fg.StreamingLoRaReceiver(samp_rate=1e6, center_freq=868e6, channel_list=[868.3e6],
                                   sf=7, cr=4, decimation=8, device="cpu")
    assert one.route == "fir"


OFF_GRID = [(-7.5 + c) * 200e3 + 13e3 for c in range(16)]   # 13 kHz off the grid


def _multichannel_capture(offsets_hz, samp_rate, payloads, seed=0, pad_before=6000):
    """Packets mixed up to their channels' offsets in one wideband stream."""
    wide_cfg = JConfig(sf=7, cr=4, samp_rate=samp_rate, crc=True)
    parts, L = [], 0
    for ci, off in enumerate(offsets_hz):
        pkt = modulate_frame(wide_cfg, payloads[ci], pad_before=pad_before + 997 * ci,
                             snr_db=None)
        parts.append((off, pkt))
        L = max(L, len(pkt))
    L += 8 * wide_cfg.samples_per_symbol
    x = np.zeros(L, np.complex128)
    for off, pkt in parts:
        t = np.arange(len(pkt))
        x[:len(pkt)] += pkt * np.exp(2j * np.pi * off / samp_rate * t)
    rng = np.random.default_rng(seed)
    x += rng.normal(0, 1e-4, (L, 2)) @ [1, 1j]
    return x.astype(np.complex64)


def test_16ch_off_grid_mixer_bank_matches_jax():
    """16 channels 13 kHz off the 200 kHz raster at 8 Msps, decimation 8,
    pushed in uneven chunks (the block and remainder bookkeeping): every
    channel decodes, as JAX's device bank decodes them."""
    payloads = [bytes([c, 0xC3]) for c in range(16)]
    x = _multichannel_capture(OFF_GRID, 8e6, payloads)
    kw = dict(samp_rate=8e6, center_freq=868e6, channel_list=[868e6 + o for o in OFF_GRID],
              sf=7, cr=4, decimation=8, engine="dense", block_symbols=256)
    out = {}
    for name, rx in (("port", fg.StreamingLoRaReceiver(device="cpu", **kw)),
                     ("jax", jfg.StreamingLoRaReceiver(**kw))):
        frames, pos, k = [], 0, 0
        sizes = [100_000, 37_123, 250_000, 1_000_000]
        while pos < len(x):
            n = sizes[k % len(sizes)]
            frames += rx.push(x[pos:pos + n])
            pos, k = pos + n, k + 1
        frames += rx.flush()
        out[name] = frames
    same_frames(out["port"], out["jax"])
    assert {f.channel: f.payload[:2] for f in out["port"]} == \
        {c: payloads[c] for c in range(16)}


def test_mixer_bank_stream_matches_jax():
    """The bank's channel streams, chunk after chunk and the flushed
    remainder, against JAX's device bank (three channels at 2 Msps,
    decimation 2, 9,001-sample chunks)."""
    offs = [-260e3, 140e3, 413e3]
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1.0, (70_000, 2)) @ [1, 1j]).astype(np.complex64)
    kw = dict(samp_rate=2e6, center_freq=868e6, channel_list=[868e6 + o for o in offs],
              sf=7, cr=4, decimation=2, engine="dense")
    rx = fg.StreamingLoRaReceiver(device="cpu", **kw)
    jrx = jfg.StreamingLoRaReceiver(**kw)
    assert rx.route == "mixer_bank" and jrx._dev_run is not None
    outs, jouts = [[] for _ in offs], [[] for _ in offs]
    for pos in range(0, len(x), 9_001):
        for ci, (a, b) in enumerate(zip(rx._channelize(x[pos:pos + 9_001]),
                                        jrx._channelize(x[pos:pos + 9_001]))):
            outs[ci].append(a)
            jouts[ci].append(b)
    for ci, (a, b) in enumerate(zip(rx._channelize_bank(np.zeros(0, np.complex64), final=True),
                                    jrx._channelize_device(np.zeros(0, np.complex64),
                                                           final=True))):
        outs[ci].append(a)
        jouts[ci].append(b)
    for a, b in zip(outs, jouts):
        a, b = np.concatenate(a), np.concatenate(b)
        assert a.dtype == np.complex64 and len(a) == len(b) > 30_000
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
    assert rx._bank_head == jrx._dev_head == len(x)


def test_gateway_block_pfb_grid_matches_jax():
    """``StreamingGateway`` on a PFB grid (M = 4, SF7 and SF8)."""
    Mg = 4
    rate = Mg * 250e3
    kw = dict(samp_rate=rate, center_freq=868.0e6, channels=Mg, sfs=(7, 8), pool=8,
              block_symbols=96)
    gwb = fg.StreamingGateway(device="cpu", **kw)
    jgwb = jfg.StreamingGateway(**kw)
    freqs = pfb_channel_freqs(rate, Mg)
    L = gwb._sr.block_len + gwb._sr.hop
    x = np.zeros(L, np.complex64)
    placements = [(7, 1, b"\x42"), (8, 2, b"\x24\x25")]
    for sf, chan, payload in placements:
        wcfg = JConfig(sf=sf, cr=4, samp_rate=rate, crc=True)
        pkt = modulate_frame(wcfg, payload, snr_db=None)
        pos = 2 * wcfg.samples_per_symbol
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * freqs[chan] / rate * t)).astype(
            np.complex64)
    got = pump(gwb, x, 200_000)
    same_frames(got, pump(jgwb, x, 200_000),
                key=lambda f: (f.tap_header.sf, f.channel, f.sample_index))
    have = {(f.tap_header.sf, f.channel): f.payload for f in got}
    for sf, chan, payload in placements:
        assert have[(sf, chan)][:len(payload)] == payload


def test_gateway_yaml_plan_matches_jax(tmp_path):
    """file_source -> lora_gateway (plan EU868) in a graph."""
    center, rate = 867.3e6, 1e6
    cfg = JConfig(sf=7, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
    pkt = modulate_frame(cfg, b"\xca\xfe", snr_db=None)
    pos = 2 * cfg.samples_per_symbol
    x = np.zeros(pos + len(pkt) + 400_000, np.complex64)
    t = np.arange(len(pkt)) + pos
    x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (867.1e6 - center) / rate * t)).astype(
        np.complex64)
    cap = tmp_path / "band.cf32"
    x.tofile(cap)
    spec = {
        "options": {"id": "t"},
        "variables": {},
        "blocks": [
            {"name": "src", "id": "file_source", "parameters": {"file": str(cap)}},
            {"name": "gw", "id": "lora_gateway",
             "parameters": {"samp_rate": rate, "center_freq": center, "plan": "EU868",
                            "sfs": [7, 8], "pool": 8, "block_symbols": 96}},
        ],
        "connections": [["src", "0", "gw", "0"]],
    }
    got = Flowgraph(spec, device="cpu").run()
    same_frames(got, jfg.Flowgraph(spec).run())
    have = {(f.tap_header.sf, f.tap_header.frequency): f.payload for f in got}
    assert have[(7, int(867.1e6))][:2] == b"\xca\xfe"


CFO_CFG = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
STEP_HZ = 6000.0   # a frame's drift, past the fractional estimator's one bin
N_FRAMES = 10      # 54 kHz at the end: outside a fixed mixer's channel filter


@pytest.fixture(scope="module")
def ramped():
    sps = CFO_CFG.samples_per_symbol
    chunks = [modulate_frame(CFO_CFG, b"\xde\xad\xbe\xef", pad_before=3000, pad_after=sps,
                             snr_db=40.0, cfo_hz=k * STEP_HZ, seed=100 + k)
              for k in range(N_FRAMES)]
    return np.concatenate(chunks + [np.zeros(4 * sps, np.complex64)])


@pytest.mark.parametrize("auto_cfo", [True, False])
def test_cfo_loop_matches_jax(ramped, auto_cfo):
    """The CFO loop: with ``auto_cfo`` each batch's last frame retunes the
    mixer and the ramp stays decoded (a retune mid-frame may cost that
    frame); without it the late frames walk out of the channel filter and
    are lost. The frames and the accumulated offset equal JAX's."""
    kw = dict(samp_rate=1e6, center_freq=868.1e6, channel_list=[868.1e6], sf=7, cr=4,
              crc=True, engine="dense", block_symbols=64, max_candidates=4, max_symbols=24,
              decimation=2, auto_cfo=auto_cfo)
    rx = fg.StreamingLoRaReceiver(device="cpu", **kw)
    jrx = jfg.StreamingLoRaReceiver(**kw)
    assert rx.route == "fir"
    got, want = pump(rx, ramped, 80_000), pump(jrx, ramped, 80_000)
    same_frames(got, want)
    good = sum(f.mac_payload == b"\xde\xad\xbe\xef" for f in got)
    assert rx.cfo[0] == pytest.approx(jrx.cfo[0], abs=4.0)
    if auto_cfo:
        assert good >= N_FRAMES - 1
        assert abs(rx.cfo[0] - (N_FRAMES - 1) * STEP_HZ) < 2.5 * STEP_HZ
    else:
        assert good <= N_FRAMES - 3 and rx.cfo[0] == 0.0
