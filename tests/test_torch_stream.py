"""The port's streamers against lora_tpu.stream, on the CPU.

Each case builds one stream with numpy from a seed (the streams of
tests/test_stream.py, tests/test_wideband_stream.py and
tests/test_plan_stream.py:115, at their sizes), pushes it in the same
chunks through JAX's streamer and the port's (``device="cpu"``), and
compares the frames one by one and in order: ``sample_index``, channel,
``tap_header.sf`` and ``.frequency``, payload, PHY header bytes,
``crc_ok``, ``dedup_replacement`` and ``replaces`` equal; ``snr`` within
rtol 1e-5 and ``cfo`` within 1 Hz (float32 sums in another order, as
tests/test_torch_wideband.py holds them); and the three dedup counters
equal.
"""

import numpy as np
import pytest
import torch

from lora_tpu import plans as jplans
from lora_tpu import stream as jstream
from lora_tpu import wideband as jwide
from lora_tpu.channelizer import pfb_channel_freqs
from lora_tpu.config import LoRaConfig as JConfig
from lora_tpu.rx.dense import DenseReceiver as JDense, DenseResult as JResult
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import (DenseReceiver, LoRaConfig, MultiSFWidebandReceiver, PlanGateway,
                            WidebandReceiver)
from lora_tpu_torch.io.frames import Frame, PhyHeader
from lora_tpu_torch.rx.dense import MAX_PAYLOAD, DenseResult
from lora_tpu_torch.stream import (StreamingReceiver, WidebandStreamingReceiver, _IngestBuffer,
                                   pump_file, stream_file)

CFG = dict(sf=7, cr=4, samp_rate=250e3, crc=True)
DENSE_KW = dict(max_candidates=8, max_symbols=24, sfd_search=12)


def assert_stream_equal(got, want):
    assert len(got) == len(want), ([(f.sample_index, f.payload.hex()) for f in got],
                                   [(f.sample_index, f.payload.hex()) for f in want])
    for g, w in zip(got, want):
        assert (g.sample_index, g.channel, g.tap_header.sf, g.tap_header.frequency,
                g.tap_header.sync_word, g.payload, g.phy_header.to_bytes(), g.crc_ok,
                g.dedup_replacement, g.replaces) == \
            (w.sample_index, w.channel, w.tap_header.sf, w.tap_header.frequency,
             w.tap_header.sync_word, w.payload, w.phy_header.to_bytes(), w.crc_ok,
             w.dedup_replacement, w.replaces)
        assert g.snr == pytest.approx(w.snr, rel=1e-5)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


def counters(sr):
    return (sr.n_dedup_suppressed, sr.n_dedup_conflicts, sr.n_dedup_replaced)


def drive(sr, x, chunk):
    frames = []
    for off in range(0, len(x), chunk):
        frames += sr.push(x[off:off + chunk])
    frames += sr.flush()
    sr.close()
    return frames


def both(make_port, make_jax, x, chunk):
    """The same stream through the port's streamer and JAX's: frames and
    counters of each."""
    sp, sj = make_port(), make_jax()
    fp, fj = drive(sp, x, chunk), drive(sj, x, chunk)
    return fp, fj, counters(sp), counters(sj)


def packet_stream(cfg, n_packets, gap_symbols=64, seed=1):
    """tests/test_stream.py's stream: packets at 40 dB with random gaps."""
    rng = np.random.default_rng(seed)
    sps = cfg.samples_per_symbol
    parts, marks, pos = [], [], 0
    for i in range(n_packets):
        gap = int(rng.integers(gap_symbols // 2, gap_symbols)) * sps
        parts.append(np.zeros(gap, np.complex64))
        pos += gap
        pkt = modulate_frame(cfg, bytes([i, 0xA5, i ^ 0xFF]), pad_before=0, pad_after=0,
                             snr_db=40.0, seed=seed + i)
        marks.append(pos)
        parts.append(pkt)
        pos += len(pkt)
    parts.append(np.zeros(32 * sps, np.complex64))
    return np.concatenate(parts), marks


@pytest.fixture(scope="module")
def jrx():
    return JDense(JConfig(**CFG), **DENSE_KW)


@pytest.fixture(scope="module")
def prx():
    return DenseReceiver(LoRaConfig(**CFG), device="cpu", **DENSE_KW)


def dense_pair(prx, jrx, block_symbols, use_native=True, **kw):
    return (lambda: StreamingReceiver(prx, block_symbols=block_symbols,
                                      use_native_ring=use_native, **kw),
            lambda: jstream.StreamingReceiver(jrx, block_symbols=block_symbols, **kw))


# ------------------------------------------------------------- dense
@pytest.mark.parametrize("use_native", [False, True])
def test_all_packets_once(prx, jrx, use_native):
    cfg = JConfig(**CFG)
    x, marks = packet_stream(cfg, 6)
    fp, fj, cp, cj = both(*dense_pair(prx, jrx, 128, use_native), x, 10_007)
    assert_stream_equal(fp, fj)
    assert cp == cj
    assert sorted(f.payload[:3] for f in fp) == sorted(bytes([i, 0xA5, i ^ 0xFF])
                                                       for i in range(6))
    for f, m in zip(sorted(fp, key=lambda f: f.sample_index), marks):
        assert abs(f.sample_index - m) <= 3 * cfg.samples_per_symbol


def test_seam_packet(prx, jrx):
    cfg = JConfig(**CFG)
    sps = cfg.samples_per_symbol
    make_p, make_j = dense_pair(prx, jrx, 64)
    hop = make_p().hop
    pkt = modulate_frame(cfg, b"\xde\xad", pad_before=0, pad_after=0, snr_db=40.0)
    x = np.zeros(3 * hop, np.complex64)
    x[hop - 2 * sps: hop - 2 * sps + len(pkt)] = pkt     # 2 symbols before the seam
    fp, fj, cp, cj = both(make_p, make_j, x, len(x))
    assert_stream_equal(fp, fj)
    assert cp == cj
    assert len(fp) == 1 and fp[0].payload[:2] == b"\xde\xad"


def test_native_ring_matches_numpy_buffer(prx, jrx):
    x, _ = packet_stream(JConfig(**CFG), 4, seed=7)
    out = {}
    for use_native in (False, True):
        out[use_native] = drive(StreamingReceiver(prx, block_symbols=128,
                                                  use_native_ring=use_native), x, len(x))
    assert_stream_equal(out[True], out[False])
    assert_stream_equal(out[True], drive(jstream.StreamingReceiver(jrx, block_symbols=128),
                                         x, len(x)))
    assert len(out[True]) == 4


def test_backpressure_small_ring(prx, jrx):
    """Pushing far more than the ring holds in one call must not drop IQ:
    a ring of two blocks forces backpressure inside the push."""
    x, _ = packet_stream(JConfig(**CFG), 10, gap_symbols=48, seed=3)
    sr = StreamingReceiver(prx, block_symbols=128)
    sr._ingest.close()
    sr._ingest = _IngestBuffer(2 * sr.block_len, use_native=True)
    assert len(x) > 4 * sr.block_len
    fp = drive(sr, x, len(x))
    fj = drive(jstream.StreamingReceiver(jrx, block_symbols=128), x, len(x))
    assert len(fp) == 10
    assert_stream_equal(fp, fj)


def test_back_to_back_minimal_gap_and_counters():
    """Two packets at the minimum spacing (the second preamble right at the
    first frame's end) both emit, with the dedup counters of JAX's run."""
    cfg = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = cfg.samples_per_symbol
    p1 = modulate_frame(cfg, b"\x01\x11", snr_db=None)
    p2 = modulate_frame(cfg, b"\x02\x22", snr_db=None)
    x = np.concatenate([np.zeros(4 * sps, np.complex64), p1, p2,
                        np.zeros(4 * sps, np.complex64)])
    rng = np.random.default_rng(0)
    x = (x + (rng.normal(0, 1e-2, (len(x), 2)) @ [1, 1j])).astype(np.complex64)
    prx = DenseReceiver(LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True), device="cpu",
                        **DENSE_KW)
    jrx = JDense(cfg, **DENSE_KW)
    fp, fj, cp, cj = both(lambda: StreamingReceiver(prx, block_symbols=128),
                          lambda: jstream.StreamingReceiver(jrx, block_symbols=128), x, 50_000)
    assert sorted(f.payload[:2] for f in fp) == [b"\x01\x11", b"\x02\x22"]
    assert_stream_equal(fp, fj)
    assert cp == cj and cp[1] == 0


def test_seam_conflict_crc_replacement():
    """A CRC-passing later decode replaces a corrupt seam-clipped blocker,
    by the injected result of tests/test_stream.py:164: flagged, counted
    once, the corrupt frame retracted; the same as JAX's."""
    from lora_tpu.io.frames import Frame as JFrame, PhyHeader as JPhy

    clean = b"\xde\xad\xbe\xef\x80\xec"     # deadbeef + valid CRC
    corrupt = b"\xde\xad\xbe\xee\x80\xec"   # one payload bit flipped
    pay = np.zeros((1, 2, MAX_PAYLOAD), np.uint8)
    pay[0, 0, :len(clean)] = np.frombuffer(clean, np.uint8)
    fields = dict(valid=np.array([[True, False]]), payload=pay,
                  length=np.array([[len(clean), 0]], np.int32),
                  snr=np.ones((1, 2), np.float32), start=np.array([[1010, 0]], np.int32),
                  cfo=np.zeros((1, 2), np.float32), n_dropped=np.array([0], np.int32))
    kw = dict(max_candidates=2, max_symbols=16, sfd_search=8)
    out = {}
    for side in ("port", "jax"):
        if side == "port":
            sr = StreamingReceiver(DenseReceiver(LoRaConfig(**CFG), device="cpu", **kw),
                                   block_symbols=64, use_native_ring=False)
            hdr = PhyHeader(length=4, has_mac_crc=1, cr=4)
            f_old = Frame(phy_header=hdr, payload=corrupt, sample_index=1000)
            res = DenseResult(hdr=torch.from_numpy(np.tile(np.frombuffer(
                hdr.to_bytes(), np.uint8), (1, 2, 1))),
                **{k: torch.from_numpy(v) for k, v in fields.items()})
            entry = (res, None, 0, 10 ** 9)
        else:
            sr = jstream.StreamingReceiver(JDense(JConfig(**CFG), **kw), block_symbols=64,
                                           use_native_ring=False)
            hdr = JPhy(length=4, has_mac_crc=1, cr=4)
            f_old = JFrame(phy_header=hdr, payload=corrupt, sample_index=1000)
            res = JResult(hdr=np.tile(np.frombuffer(hdr.to_bytes(), np.uint8), (1, 2, 1)),
                          **fields)
            entry = (res, 0, 10 ** 9)
        assert f_old.crc_ok is False
        sr._emitted_starts.append((1000, corrupt, f_old))
        sr._frames.append(f_old)
        sr._pending.append(entry)
        sr._drain(0)
        frames = sr._collect()
        assert f_old not in frames
        out[side] = (frames, counters(sr))
    (fp, cp), (fj, cj) = out["port"], out["jax"]
    assert cp == cj == (0, 1, 1)
    assert_stream_equal(fp, fj)
    assert len(fp) == 1 and fp[0].payload == clean and fp[0].crc_ok
    assert fp[0].dedup_replacement and fp[0].replaces == 1000


def test_pump_file_drops_trailing_partial_element(tmp_path, prx, jrx):
    """A capture whose size is not a multiple of 8 bytes (a recorder killed
    mid-write): the partial complex64 is dropped; ``stream_file`` and
    ``pump_file`` give JAX's frames."""
    x, _ = packet_stream(JConfig(**CFG), 3, seed=11)
    p = tmp_path / "capture.cf32"
    p.write_bytes(x.tobytes() + b"\x01\x02\x03")
    got = stream_file(str(p), prx, block_symbols=128)
    want = jstream.stream_file(str(p), jrx, block_symbols=128)
    assert len(got) == 3
    assert_stream_equal(got, want)
    sr = StreamingReceiver(prx, block_symbols=128)
    assert_stream_equal(pump_file(sr, str(p), chunk_samples=9_999),
                        jstream.pump_file(jstream.StreamingReceiver(jrx, block_symbols=128),
                                          str(p), chunk_samples=9_999))
    assert sr._ingest._ring is None   # closed


def test_gradient_engine_streams():
    """The gradient engine (JAX's "auto" at 1 Msps) under StreamingReceiver."""
    cfg = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    x, _ = packet_stream(cfg, 3, gap_symbols=40, seed=5)
    prx = DenseReceiver(LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True), device="cpu",
                        **DENSE_KW)
    jrx = JDense(cfg, **DENSE_KW)
    assert prx.method == "gradient"
    fp, fj, cp, cj = both(lambda: StreamingReceiver(prx, block_symbols=128),
                          lambda: jstream.StreamingReceiver(jrx, block_symbols=128), x, 77_777)
    assert len(fp) == 3
    assert_stream_equal(fp, fj)
    assert cp == cj


def test_stream_geometry_and_refusals(prx):
    sr = StreamingReceiver(prx, block_symbols=128, use_native_ring=False)
    assert (sr.hop, sr.halo, sr.block_len) == (128 * 256, prx.pkt_samples + 512,
                                               128 * 256 + prx.pkt_samples + 512)
    assert sr._stager.device.type == "cpu" and len(sr._stager._slots) == 3
    with pytest.raises(ValueError, match="use a larger block"):
        StreamingReceiver(prx, block_symbols=16)


def test_native_ring_without_compiler_raises(monkeypatch, tmp_path, prx):
    """``use_native_ring=True`` builds the host library or raises: with no
    compiler and no built library there is no quiet numpy fallback."""
    from lora_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        StreamingReceiver(prx, block_symbols=128, use_native_ring=True)
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------- wideband
M = 8
WIDE_RATE = M * 250e3


def wideband_stream(placements, total_chan_samples):
    """tests/test_wideband_stream.py's capture: ``(channel, channel-rate
    position, payload[, sf])`` upconverted into one wideband stream."""
    x = np.zeros(total_chan_samples * M, np.complex64)
    freqs = pfb_channel_freqs(WIDE_RATE, M)
    for chan, pos_chan, payload, *sf in placements:
        wcfg = JConfig(sf=sf[0] if sf else 7, cr=4, samp_rate=WIDE_RATE, crc=True)
        pkt = modulate_frame(wcfg, payload, snr_db=None)
        pos = pos_chan * M
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * freqs[chan] / WIDE_RATE * t)
                                  ).astype(np.complex64)
    return x


@pytest.mark.parametrize("pool", [None, 8])
def test_wideband_stream_across_seams(pool):
    kw = dict(pool=pool, max_candidates=2, max_symbols=24, sfd_search=12, demod_method="fft")
    wr = WidebandReceiver(LoRaConfig(**CFG), M, device="cpu", **kw)
    jwr = jwide.WidebandReceiver(JConfig(**CFG), M, **kw)
    make_p = lambda: WidebandStreamingReceiver(wr, block_symbols=256)   # noqa: E731
    make_j = lambda: jstream.WidebandStreamingReceiver(jwr, block_symbols=256)   # noqa: E731
    hop_chan = make_p().hop // M
    sps = JConfig(**CFG).samples_per_symbol
    placements = [(1, 4 * sps, b"\xde\xad\xbe\xef"),          # early, block 0
                  (3, hop_chan - 20 * sps, b"\x11\x22\x33"),  # straddles the seam
                  (6, hop_chan + 30 * sps, b"\x44\x55"),      # block 1
                  (1, 2 * hop_chan + 8 * sps, b"\x66")]       # block 2, same channel
    x = wideband_stream(placements, 3 * hop_chan + 60 * sps)
    fp, fj, cp, cj = both(make_p, make_j, x, 100_000)
    assert len(fp) == len(placements)
    for chan, _, payload in placements:
        assert any(f.channel == chan and f.payload[:len(payload)] == payload for f in fp)
    assert_stream_equal(fp, fj)
    assert cp == cj


def test_wideband_stream_no_duplicate_on_overlap():
    """A packet inside block k's halo and block k+1's owned region is
    emitted once."""
    kw = dict(pool=4, max_candidates=2, max_symbols=24, sfd_search=12, demod_method="fft")
    wr = WidebandReceiver(LoRaConfig(**CFG), M, device="cpu", **kw)
    jwr = jwide.WidebandReceiver(JConfig(**CFG), M, **kw)
    hop_chan = WidebandStreamingReceiver(wr, block_symbols=256, use_native_ring=False).hop // M
    sps = JConfig(**CFG).samples_per_symbol
    x = wideband_stream([(2, hop_chan + 2 * sps, b"\xab\xcd")], 2 * hop_chan + 50 * sps)
    fp, fj, cp, cj = both(lambda: WidebandStreamingReceiver(wr, block_symbols=256),
                          lambda: jstream.WidebandStreamingReceiver(jwr, block_symbols=256),
                          x, 200_000)
    assert len(fp) == 1 and fp[0].channel == 2 and fp[0].payload[:2] == b"\xab\xcd"
    assert_stream_equal(fp, fj)
    assert cp == cj


def test_two_sf_gateway_streams():
    """A two-SF ``MultiSFWidebandReceiver`` (SF7 and SF8, M = 8) streamed:
    one packet each, one across a seam; frames stamped with their SF."""
    kw = dict(sfs=(7, 8), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
              demod_method="fft")
    gw = MultiSFWidebandReceiver(LoRaConfig(**CFG), M, device="cpu", **kw)
    jgw = jwide.MultiSFWidebandReceiver(JConfig(**CFG), M, **kw)
    make_p = lambda: WidebandStreamingReceiver(gw, block_symbols=64)   # noqa: E731
    make_j = lambda: jstream.WidebandStreamingReceiver(jgw, block_symbols=64)   # noqa: E731
    hop_chan = make_p().hop // M
    sps8 = 512
    placements = [(2, 3 * sps8, b"\xca\xfe", 7), (5, hop_chan - 3 * sps8, b"\xf0\x0d", 8)]
    x = wideband_stream(placements, 2 * hop_chan + 40 * sps8)
    fp, fj, cp, cj = both(make_p, make_j, x, 123_457)
    assert sorted((f.tap_header.sf, f.channel, f.payload[:2]) for f in fp) == \
        [(7, 2, b"\xca\xfe"), (8, 5, b"\xf0\x0d")]
    assert_stream_equal(fp, fj)
    assert cp == cj


def plan_capture(center, rate, placements, L, seed=7):
    """tests/test_plan_stream.py's capture."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for sf, f_abs, payload, pos in placements:
        wcfg = JConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, payload, snr_db=None)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (f_abs - center) / rate
                                               * t[pos:pos + len(pkt)])).astype(np.complex64)
    return x


def test_plan_gateway_streams():
    """tests/test_plan_stream.py:115: EU868 at 867.3 MHz, 1 Msps, SF7-8,
    three packets (one across the first seam), odd chunks."""
    center, rate = 867.3e6, 1e6
    kw = dict(sfs=(7, 8), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
              demod_method="fft")
    gw = PlanGateway("EU868", center, rate, device="cpu", **kw)
    jgw = jplans.PlanGateway("EU868", center, rate, **kw)
    assert gw.channels == [867.1e6, 867.3e6, 867.5e6]
    make_p = lambda: WidebandStreamingReceiver(gw, block_symbols=96)   # noqa: E731
    make_j = lambda: jstream.WidebandStreamingReceiver(jgw, block_symbols=96)   # noqa: E731
    sr = make_p()
    sps8 = int(2 ** 8 * rate / 125e3)
    seam = sr.hop
    placements = [(7, 867.1e6, b"\x42\x43", 2 * sps8),
                  (8, 867.5e6, b"\x24", seam - 6 * sps8),
                  (7, 867.3e6, b"\xa5\x5a", seam + sr.hop // 2)]
    x = plan_capture(center, rate, placements, 2 * sr.hop + sr.hop // 2 + 40 * sps8)
    fp, fj, cp, cj = both(make_p, make_j, x, sr.block_len // 2 + 123)
    got = {(f.tap_header.sf, f.tap_header.frequency): f.payload for f in fp}
    for sf, f_abs, payload, _ in placements:
        assert got[(sf, int(f_abs))][:len(payload)] == payload
    assert len(fp) == len(placements)
    assert_stream_equal(fp, fj)
    assert cp == cj
    # ...and the one-shot decode agrees
    assert {(f.tap_header.sf, f.tap_header.frequency, f.payload) for f in fp} == \
        {(f.tap_header.sf, f.tap_header.frequency, f.payload) for f in gw.run(x)}


def test_stager_planes_equal_pack_iq():
    """On the CPU the stager's planes are ``pack_iq``'s, slot after slot;
    a slot refilled later does not change planes already staged."""
    from lora_tpu_torch.ops.xfer import PinnedStager, pack_iq

    rng = np.random.default_rng(4)
    blocks = [(rng.normal(size=(1000, 2)) @ [1, 1j]).astype(np.complex64) for _ in range(5)]
    st = PinnedStager(1000, 2, device="cpu")
    staged = []
    for b in blocks:
        staged.append(st.stage(lambda buf, b=b: buf.__setitem__(slice(None), b)))
    for b, planes in zip(blocks, staged):
        assert planes.dtype == torch.float32 and planes.shape == (2, 1000)
        assert torch.equal(planes, pack_iq(b, device="cpu"))


def test_sf11_drift_pass_fault_is_the_references():
    """A receiver fault found by the streamed EU868 capture (ROADMAP.md §3),
    not a streaming one: at SF11 (EU868, 2 Msps) the fft drift pass
    decodes the clean packet ``deadbeef0400`` placed 3,510 channel samples
    past a symbol boundary as ``deadbebf0408`` (the CRC fails); without
    the drift pass it decodes right. The port gives JAX's frame, fault
    included."""
    center, rate = 868.0e6, 2e6
    kw = dict(sfs=(11,), pool=8, max_candidates=2, max_symbols=24, sfd_search=12,
              demod_method="fft")
    sent = bytes.fromhex("deadbeef0400")
    wcfg = JConfig(sf=11, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
    pkt = modulate_frame(wcfg, sent, snr_db=None)
    rng = np.random.default_rng(8)
    L = len(pkt) + 400_000
    x = (1e-3 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    pos = 8 * (2 * 4096 + 3510)
    t = np.arange(pos, pos + len(pkt), dtype=np.float64)
    x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * ((867.5e6 - center) / rate * t % 1.0))
                              ).astype(np.complex64)
    got = PlanGateway("EU868", center, rate, device="cpu", **kw).run(x)
    assert_stream_equal(got, jplans.PlanGateway("EU868", center, rate, **kw).run(x))
    assert [(f.channel, f.payload[:6].hex(), f.crc_ok) for f in got] == \
        [(4, "deadbebf0408", False)]
    right = PlanGateway("EU868", center, rate, device="cpu", fft_drift_pass=False, **kw).run(x)
    assert [(f.channel, f.payload[:6], f.crc_ok) for f in right] == [(4, sent, True)]
