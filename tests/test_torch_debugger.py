"""The port's sample debugger (``lora_tpu_torch.debugger``) against
``lora_tpu.debugger``: the bytes on the wire (the reference's packed
``{uint32 length_be, uint8 draw_over}`` header, then complex64 samples,
include/lora/debugger.h:40-43) equal JAX's, each package's client talks
to the other's analyzer, and the scope loop and the sample dumps behave
as JAX's (mirrors tests/test_debugger.py)."""

import socket
import threading
import time

import numpy as np
import pytest

from lora_tpu import debugger as jdbg

from lora_tpu_torch import debugger as dbg

BUFFERS = [([np.arange(8, dtype=np.complex64), np.arange(4, dtype=np.complex64) * 1j], False),
           ([np.ones(3, np.complex64)], True),
           ([], False)]


def _wire_bytes(mod, path):
    """Every byte a ``mod.SampleDebugger`` sends for ``BUFFERS``."""
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(path)
    server.listen(1)
    d = mod.SampleDebugger()
    d.attach(path)
    conn, _ = server.accept()
    assert d.attached
    for parts, draw_over in BUFFERS:
        for p in parts:
            d.store_samples(p)
        d.analyze_samples(clear=True, draw_over=draw_over)
    d.detach()
    chunks = []
    while True:
        b = conn.recv(65536)
        if not b:
            break
        chunks.append(b)
    conn.close()
    server.close()
    return b"".join(chunks)


def test_wire_bytes_equal_jax(tmp_path):
    got = _wire_bytes(dbg, str(tmp_path / "p.sock"))
    want = _wire_bytes(jdbg, str(tmp_path / "j.sock"))
    assert got == want
    assert got[:5] == (12 * 8).to_bytes(4, "big") + b"\x00"


@pytest.mark.parametrize("client,server", [(dbg, jdbg), (jdbg, dbg)],
                         ids=["port-to-jax", "jax-to-port"])
def test_client_and_analyzer_interoperate(tmp_path, client, server):
    path = str(tmp_path / "scope.sock")
    srv = server.AnalyzerServer(path)

    def send():
        d = client.SampleDebugger()
        d.attach(path)
        for parts, draw_over in BUFFERS:
            for p in parts:
                d.store_samples(p)
            d.analyze_samples(draw_over=draw_over)
        d.detach()

    t = threading.Thread(target=send)
    t.start()
    srv.accept(timeout=5.0)
    got = list(srv)
    t.join()
    srv.close()
    assert [(len(s), d) for s, d in got] == [(12, False), (3, True), (0, False)]
    np.testing.assert_array_equal(got[0][0], np.concatenate(BUFFERS[0][0]))


def test_unattached_is_noop():
    d = dbg.SampleDebugger()
    d.store_samples(np.ones(4, np.complex64))
    d.analyze_samples()
    d.attach("/nonexistent/path.sock")
    assert not d.attached


def test_live_analyze_matches_jax(tmp_path):
    """``live_analyze`` with a callback and ``max_buffers``, fed by the
    same client, sees what JAX's sees."""
    seen = {}
    for name, mod in (("port", dbg), ("jax", jdbg)):
        path = str(tmp_path / f"{name}.sock")
        got = []

        def client():
            d = dbg.SampleDebugger()
            for _ in range(200):
                d.attach(path)
                if d.attached:
                    break
                time.sleep(0.02)
            for k in range(3):
                d.store_samples(np.full(5 + k, 2.0 + k, np.complex64))
                d.analyze_samples(draw_over=bool(k % 2))
            d.detach()

        t = threading.Thread(target=client)
        t.start()
        n = mod.live_analyze(path, on_buffer=lambda s, o: got.append((s.copy(), o)),
                             max_buffers=2)
        t.join()
        seen[name] = (n, [(s.tolist(), o) for s, o in got])
    assert seen["port"] == seen["jax"] and seen["port"][0] == 2


def test_dump_samples_matches_jax(tmp_path):
    for mod, d in ((dbg, tmp_path / "p"), (jdbg, tmp_path / "j")):
        d.mkdir()
        mod.dump_samples("tap", np.arange(4, dtype=np.complex64), str(d))
        mod.dump_samples("tap", np.arange(2, dtype=np.complex64), str(d))
    got = (tmp_path / "p" / "tap").read_bytes()
    assert got == (tmp_path / "j" / "tap").read_bytes()
    np.testing.assert_array_equal(np.frombuffer(got, np.complex64),
                                  np.r_[np.arange(4), np.arange(2)])
