"""The port's flowgraph layer (``lora_tpu_torch.flowgraph``) against
``lora_tpu.flowgraph``: expression evaluation, the block descriptors, the
graph rejections, and graphs run end to end on the CPU (``device="cpu"``)
beside JAX's on the same captures and specs (mirrors
tests/test_flowgraph.py). Frames are held equal in payload, header bytes,
channel, sample index and tap header frequency, with ``snr`` and ``cfo``
to float32 rounding (rtol 1e-4; cfo within 2 Hz), as the facade's tests
hold them; the one-channel stream to float32 rounding of its largest
magnitude."""

import socket
import threading
import time

import numpy as np
import pytest

from lora_tpu import LoRaConfig as JConfig
from lora_tpu import flowgraph as jfg
from lora_tpu.channelizer import freq_xlating_fir as jxlating
from lora_tpu.channelizer import lora_channel_taps as jtaps
from lora_tpu.io.frames import Frame as JFrame
from lora_tpu.io.frames import PhyHeader as JPhyHeader
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import flowgraph as fg
from lora_tpu_torch import Flowgraph, run_flowgraph

DEADBEEF = bytes.fromhex("deadbeef")
CFG = JConfig(sf=7, cr=4, samp_rate=250e3, crc=True)


def same_frames(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.payload, g.phy_header.to_bytes(), g.channel, g.sample_index,
                g.tap_header.frequency) == \
            (w.payload, w.phy_header.to_bytes(), w.channel, w.sample_index,
             w.tap_header.frequency)
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=2.0)


def both(spec):
    """The spec built by both packages: ``(port graph, JAX graph)``."""
    return Flowgraph(spec, device="cpu"), jfg.Flowgraph(spec)


@pytest.mark.parametrize("expr,variables", [
    ("samp_rate", {"samp_rate": 1e6}),
    ("samp_rate + offset", {"samp_rate": 1e6, "offset": 100e3}),
    ("int(samp_rate // 4)", {"samp_rate": 1e6}),
    (["offset", "2 * offset"], {"offset": 100e3}),
    (7, {}), (True, {}), (None, {}),
    ("-x ** 2 % 7", {"x": 5}), ("not 0", {}), ("max(1, 2.5) - abs(-3)", {}),
    ("127.0.0.1", {}), ("frames.bin", {}), ("__import__('os')", {}),
    ("[1, (2, 3)]", {}), ("'EU868'", {}),
])
def test_safe_eval_matches_jax(expr, variables):
    got = fg.safe_eval(expr, variables)
    assert got == jfg.safe_eval(expr, variables) and type(got) is type(
        jfg.safe_eval(expr, variables))


def test_safe_eval_unknown_name_raises():
    for mod in (fg, jfg):
        with pytest.raises(NameError):
            mod.safe_eval("nonexistent + 1", {})


def test_block_descriptors_equal_jax():
    got = fg.block_descriptors()
    assert len(got) == 12 and got == jfg.block_descriptors()
    assert list(fg.BLOCKS) == list(jfg.BLOCKS)
    assert [b.kind for b in fg.BLOCKS.values()] == [b.kind for b in jfg.BLOCKS.values()]


def _minimal_spec(tmp_path):
    p = tmp_path / "x.cf32"
    np.zeros(4096, np.complex64).tofile(p)
    return {
        "blocks": [
            {"name": "src", "id": "file_source", "parameters": {"file": str(p)}},
            {"name": "rx", "id": "lora_receiver",
             "parameters": {"samp_rate": 250e3, "center_freq": 868e6,
                            "channel_list": [868e6]}},
        ],
        "connections": [["src", "0", "rx", "0"]],
    }


def _unknown_block(spec):
    spec["blocks"][0]["id"] = "warp_drive"
    return "unknown block id"


def _unknown_param(spec):
    spec["blocks"][1]["parameters"]["warp"] = 9
    return "unknown parameters"


def _no_path(spec):
    spec["connections"] = []
    return "no stream path"


def _midchain_fanout(spec):
    spec["blocks"][1:1] = [
        {"name": "thr", "id": "throttle", "parameters": {"samp_rate": 250e3}},
        {"name": "thr2", "id": "throttle", "parameters": {"samp_rate": 250e3}}]
    spec["connections"] = [["src", "0", "thr", "0"], ["src", "0", "thr2", "0"],
                           ["thr", "0", "rx", "0"], ["thr2", "0", "rx", "0"]]
    return "fan-out"


@pytest.mark.parametrize("breaks", [_unknown_block, _unknown_param, _no_path,
                                    _midchain_fanout])
def test_graph_rejections_match_jax(tmp_path, breaks):
    spec = _minimal_spec(tmp_path)
    match = breaks(spec)
    for make in (lambda s: Flowgraph(s, device="cpu"), jfg.Flowgraph):
        with pytest.raises(ValueError, match=match):
            make(spec)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    sps = CFG.samples_per_symbol
    pkt = modulate_frame(CFG, DEADBEEF, pad_before=8 * sps, pad_after=40 * sps, snr_db=40.0)
    path = tmp_path_factory.mktemp("fg") / "cap.cf32"
    pkt.astype(np.complex64).tofile(path)
    return path


def test_file_decode_matches_jax(capture):
    spec = {
        "variables": {"samp_rate": 250e3, "freq": 868.0e6},
        "blocks": [
            {"name": "src", "id": "file_source",
             "parameters": {"file": str(capture), "chunk_samples": 16384}},
            {"name": "thr", "id": "throttle", "parameters": {"samp_rate": "samp_rate * 1000"}},
            {"name": "rx", "id": "lora_receiver",
             "parameters": {"samp_rate": "samp_rate", "center_freq": "freq",
                            "channel_list": ["freq"], "sf": 7, "cr": 4, "crc": True,
                            "block_symbols": 128}},
            {"name": "out", "id": "frame_collect_sink"},
        ],
        "connections": [["src", "0", "thr", "0"], ["thr", "0", "rx", "0"],
                        ["rx", "frames", "out", "in"]],
    }
    g, j = both(spec)
    assert g.blocks["rx"].route == "none"
    got = g.run()
    same_frames(got, j.run())
    assert [f.mac_payload for f in got] == [DEADBEEF]
    assert [f.mac_payload for f in g.blocks["out"].frames] == [DEADBEEF]


def test_yaml_udp_and_file_sinks_match_jax(tmp_path, capture):
    """``from_yaml`` with a UDP sink (LoRaMAC layer) and a file sink
    (LoRaTap): the datagrams and the file's bytes equal JAX's graph's."""
    got = {}
    for name in ("port", "jax"):
        rxsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rxsock.bind(("127.0.0.1", 0))
        rxsock.settimeout(10.0)
        port = rxsock.getsockname()[1]
        out = tmp_path / f"{name}.bin"
        y = tmp_path / f"{name}.yml"
        y.write_text(f"""
variables:
  samp_rate: 250e3
  freq: 868.0e6
blocks:
- {{name: src, id: file_source, parameters: {{file: {capture}}}}}
- name: rx
  id: lora_receiver
  parameters:
    samp_rate: samp_rate
    center_freq: freq
    channel_list: [freq]
    sf: 7
    block_symbols: 128
- {{name: udp, id: message_socket_sink, parameters: {{port: {port}, layer: 2}}}}
- {{name: file, id: message_file_sink, parameters: {{file: {out}}}}}
connections:
- [src, '0', rx, '0']
- [rx, frames, udp, in]
- [rx, frames, file, in]
""")
        frames = (run_flowgraph(str(y), device="cpu") if name == "port"
                  else jfg.run_flowgraph(str(y)))
        datagram, _ = rxsock.recvfrom(4096)
        rxsock.close()
        got[name] = (frames, datagram, out.read_bytes())
    same_frames(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == DEADBEEF
    assert got["port"][2] == got["jax"][2] == got["port"][0][0].to_bytes(0)


def test_offset_channel_chunked_matches_jax():
    """A channel at +50 kHz of a 1 Msps capture, decimation 4, pushed in
    awkward chunks: the one-channel route (the FIR on the device, the
    filter tail and the decimation phase carried) decodes as JAX's host
    FIR does."""
    wide = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps_w = wide.samples_per_symbol
    pkt = modulate_frame(wide, DEADBEEF, pad_before=8 * sps_w, pad_after=40 * sps_w,
                         snr_db=40.0)
    n = np.arange(len(pkt))
    x = (pkt * np.exp(2j * np.pi * 50e3 * n / 1e6)).astype(np.complex64)
    kw = dict(samp_rate=1e6, center_freq=868.0e6, channel_list=[868.05e6], sf=7, cr=4,
              crc=True, decimation=4, block_symbols=128)
    out = {}
    for name, rx in (("port", fg.StreamingLoRaReceiver(device="cpu", **kw)),
                     ("jax", jfg.StreamingLoRaReceiver(**kw))):
        sink = (fg if name == "port" else jfg).FrameCollectSink()
        rx.sinks = [sink]
        for i in range(0, len(x), 10000):
            rx.push(x[i:i + 10000])
        rx.flush()
        rx.close()
        out[name] = sink.frames
    same_frames(out["port"], out["jax"])
    assert [f.mac_payload for f in out["port"]] == [DEADBEEF]


def test_chunked_channelizer_matches_whole_and_jax():
    """Chunk-wise FIR with tail and phase carry: equal to one
    ``freq_xlating_fir`` over the whole stream, and to JAX's chunked
    stream to float32 rounding."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, (50000, 2)) @ np.array([1, 1j])).astype(np.complex64)
    kw = dict(samp_rate=1e6, center_freq=868e6, channel_list=[868.1e6], sf=7, decimation=4,
              engine="golden")
    rx = fg.StreamingLoRaReceiver(device="cpu", **kw)
    jrx = jfg.StreamingLoRaReceiver(**kw)
    assert rx.route == "fir"
    outs, jouts = [], []
    for i in range(0, len(x), 7777):
        outs.append(rx._channelize(x[i:i + 7777])[0])
        jouts.append(jrx._channelize(x[i:i + 7777])[0])
    chunked, jchunked = np.concatenate(outs), np.concatenate(jouts)
    assert chunked.dtype == np.complex64 and len(chunked) == len(jchunked) > 12000
    scale = np.abs(jchunked).max()
    np.testing.assert_allclose(chunked, jchunked, rtol=1e-5, atol=1e-6 * scale)
    whole = jxlating(x, jtaps(1e6, 125e3), 100e3, 1e6, 4)
    m = min(len(chunked), len(whole))
    np.testing.assert_allclose(chunked[:m], whole[:m], rtol=1e-5, atol=1e-6 * scale)


def test_udp_iq_source_matches_jax():
    """IQ datagrams in, frames out (lora_receive_realtime)."""
    sps = CFG.samples_per_symbol
    pkt = modulate_frame(CFG, DEADBEEF, pad_before=8 * sps, pad_after=40 * sps,
                         snr_db=40.0).astype(np.complex64)
    out = {}
    for name in ("port", "jax"):
        spec = {
            "blocks": [
                {"name": "sdr", "id": "udp_iq_source",
                 "parameters": {"addr": "127.0.0.1", "port": 0, "timeout": 2.0,
                                "max_samples": len(pkt)}},
                {"name": "rx", "id": "lora_receiver",
                 "parameters": {"samp_rate": 250e3, "center_freq": 868e6,
                                "channel_list": [868e6], "sf": 7, "block_symbols": 128}},
                {"name": "out", "id": "frame_collect_sink"},
            ],
            "connections": [["sdr", "0", "rx", "0"], ["rx", "frames", "out", "in"]],
        }
        g = Flowgraph(spec, device="cpu") if name == "port" else jfg.Flowgraph(spec)
        port = g.blocks["sdr"].sock.getsockname()[1]

        def sender():
            tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            raw = pkt.tobytes()
            for i in range(0, len(raw), 8192):
                tx.sendto(raw[i:i + 8192], ("127.0.0.1", port))
                time.sleep(0.0005)
            tx.close()

        t = threading.Thread(target=sender)
        t.start()
        out[name] = g.run()
        t.join()
    same_frames(out["port"], out["jax"])
    assert [f.mac_payload for f in out["port"]] == [DEADBEEF]


def test_message_only_graph_matches_jax():
    """message_socket_source -> sinks (the reference's republish topology,
    lib/message_socket_source_impl.cc:49-97): a datagram that is not a
    LoRaTap frame is skipped, the others republished, as JAX's graph
    does."""
    frame = JFrame(phy_header=JPhyHeader(length=2, cr=4, has_mac_crc=1),
                   payload=b"\xab\xcd\x01\x02")
    datagram = frame.to_bytes(0)
    out = {}
    for name in ("port", "jax"):
        spec = {
            "options": {"id": "msg_graph"},
            "blocks": [
                {"name": "src", "id": "message_socket_source",
                 "parameters": {"addr": "127.0.0.1", "port": 0}},
                {"name": "collect", "id": "frame_collect_sink"},
            ],
            "connections": [["src", "out", "collect", "in"]],
        }
        g = Flowgraph(spec) if name == "port" else jfg.Flowgraph(spec)
        src = g.blocks["src"]
        port = src.sock.getsockname()[1]

        def send():
            time.sleep(0.2)
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(b"short", ("127.0.0.1", port))
            for _ in range(3):
                s.sendto(datagram, ("127.0.0.1", port))
                time.sleep(0.05)
            s.close()

        t = threading.Thread(target=send)
        t.start()
        out[name] = g.run(max_frames=3, max_seconds=10.0)
        t.join()
    assert len(out["port"]) == len(out["jax"]) == 3
    for f, w in zip(out["port"], out["jax"]):
        assert f.to_bytes(0) == w.to_bytes(0) == datagram
        assert f.snr == w.snr


def test_multi_receiver_multi_sf_matches_jax(tmp_path):
    """One source fanned out to an SF7 and an SF8 receiver."""
    c7 = JConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    c8 = JConfig(sf=8, cr=4, samp_rate=250e3, crc=True)
    sps8 = c8.samples_per_symbol
    p7 = modulate_frame(c7, b"\x07\x07", pad_before=4096, snr_db=40.0)
    p8 = modulate_frame(c8, b"\x08\x08", pad_before=4096, snr_db=40.0)
    cap = np.concatenate([p7, np.zeros(2 * sps8, np.complex64), p8,
                          np.zeros(48 * sps8, np.complex64)])
    path = tmp_path / "cap.cf32"
    cap.astype(np.complex64).tofile(path)

    def rx_params(sf):
        return {"samp_rate": 250e3, "center_freq": 868e6, "channel_list": [868e6], "sf": sf,
                "cr": 4, "crc": True, "block_symbols": 128}

    spec = {
        "blocks": [
            {"name": "src", "id": "file_source",
             "parameters": {"file": str(path), "chunk_samples": 16384}},
            {"name": "rx7", "id": "lora_receiver", "parameters": rx_params(7)},
            {"name": "rx8", "id": "lora_receiver", "parameters": rx_params(8)},
            {"name": "out", "id": "frame_collect_sink"},
        ],
        "connections": [["src", "0", "rx7", "0"], ["src", "0", "rx8", "0"],
                        ["rx7", "frames", "out", "in"], ["rx8", "frames", "out", "in"]],
    }
    g, j = both(spec)
    got = g.run()
    same_frames(got, j.run())
    assert sorted(f.mac_payload for f in got) == [b"\x07\x07", b"\x08\x08"]


@pytest.mark.parametrize("engine", ["parity", "golden"])
def test_buffered_engines_match_jax(tmp_path, engine):
    """One-channel graphs on the buffered engines (decoded at ``flush()``
    through the facade): the port's frames equal JAX's, and the parity
    and golden graphs decide the same frames."""
    wide = JConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = wide.samples_per_symbol
    pkts = [modulate_frame(wide, bytes([k]) + DEADBEEF, pad_before=3000, pad_after=2 * sps,
                           snr_db=40.0, seed=k) for k in range(2)]
    path = tmp_path / "cap.cf32"
    np.concatenate(pkts + [np.zeros(4 * sps, np.complex64)]).tofile(path)
    spec = {
        "blocks": [
            {"name": "src", "id": "file_source",
             "parameters": {"file": str(path), "chunk_samples": 30011}},
            {"name": "rx", "id": "lora_receiver",
             "parameters": {"samp_rate": 1e6, "center_freq": 868e6,
                            "channel_list": [868.0e6], "sf": 7, "engine": repr(engine)}},
        ],
        "connections": [["src", "0", "rx", "0"]],
    }
    g, j = both(spec)
    got = g.run()
    same_frames(got, j.run())
    assert [f.mac_payload for f in got] == [bytes([k]) + DEADBEEF for k in range(2)]


@pytest.mark.parametrize("example", sorted(
    p.name for p in (__import__("pathlib").Path(__file__).resolve().parent.parent
                     / "examples").glob("*.yml")))
def test_examples_parse_as_jax_parses_them(example):
    """examples/*.yml, unchanged: every block is registered, every
    parameter known to its block, and every value evaluates as JAX's
    runner evaluates it (the graphs name captures, sockets and stdin, so
    they are not run here)."""
    import pathlib

    import yaml

    spec = yaml.safe_load((pathlib.Path(__file__).resolve().parent.parent / "examples"
                           / example).read_text())
    variables, jvariables = {}, {}
    for k, v in (spec.get("variables") or {}).items():
        variables[k] = fg.safe_eval(v, variables)
        jvariables[k] = jfg.safe_eval(v, jvariables)
    assert variables == jvariables
    assert spec["blocks"]
    for b in spec["blocks"]:
        reg = fg.BLOCKS[b["id"]]
        params = b.get("parameters") or {}
        assert set(params) <= {p.id for p in reg.params}, (b["name"], sorted(params))
        for k, v in params.items():
            assert value(fg, v, variables) == value(jfg, v, jvariables), (b["name"], k)


def value(mod, v, variables):
    """A parameter's value as the runner takes it: a bare word that names
    no variable is the word itself (string parameters)."""
    try:
        return mod.safe_eval(v, variables)
    except NameError:
        return str(v)
