"""The port's host library (``lora_tpu_torch.native``) and its sinks, on
the CPU.

- The sample ring against a numpy model of the same ring and against
  ``lora_tpu.native.SampleRing``, op by op: writes (short ones under
  backpressure), peeks, reads and advances, around the wrap; ``peek_into``
  a caller's numpy array or tensor.
- Two processes building the library into one empty directory at once
  end with one loadable library.
- UDP: the sink (native and Python backends) to ``LoRaUDPServer`` on a
  port of the kernel's choice; the native and Python sources.
- The file sink writes the bytes JAX's writes.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lora_tpu import native as jnative
from lora_tpu.io import frames as jframes
from lora_tpu.io.sinks import MessageFileSink as JFileSink

from lora_tpu_torch import native
from lora_tpu_torch.io import frames as pframes
from lora_tpu_torch.io.frames import LORAMAC, LORAPHY, LORATAP
from lora_tpu_torch.io.sinks import MessageFileSink, MessageMongoDBSink
from lora_tpu_torch.io.udp import LoRaUDPServer, MessageSocketSink, MessageSocketSource

ROOT = Path(__file__).resolve().parent.parent


class RingModel:
    """The ring's contract in numpy: a bounded FIFO of bytes."""

    def __init__(self, cap):
        self.cap, self.buf = cap, b""

    def write(self, data):
        n = min(len(data), self.cap - len(self.buf))
        self.buf += data[:n]
        return n

    def peek(self, n):
        return self.buf[:n]

    def read(self, n):
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def advance(self, n):
        n = min(n, len(self.buf))
        self.buf = self.buf[n:]
        return n


@pytest.mark.parametrize("cap,seed", [(64, 0), (1000, 1), (8 * 1024, 2)])
def test_ring_matches_model_and_jax(cap, seed):
    rng = np.random.default_rng(seed)
    ring, model = native.SampleRing(cap), RingModel(cap)
    jring = jnative.SampleRing(cap) if jnative.available() else None
    try:
        assert ring.capacity == cap
        for step in range(400):
            op = rng.integers(4)
            n = int(rng.integers(0, cap + cap // 2))
            if op == 0:
                data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                got, want = ring.write(data), model.write(data)
                if jring is not None:
                    assert jring.write(data) == want
            elif op == 1:
                got, want = ring.peek(n), model.peek(n)
                if jring is not None:
                    assert jring.peek(n) == want
            elif op == 2:
                got, want = ring.read(n), model.read(n)
                if jring is not None:
                    assert jring.read(n) == want
            else:
                got, want = ring.advance(n), model.advance(n)
                if jring is not None:
                    assert jring.advance(n) == want
            assert got == want, (step, op, n)
            assert ring.readable == len(model.buf)
    finally:
        ring.close()
        if jring is not None:
            jring.close()


def test_ring_short_writes_under_backpressure():
    """A write larger than the free space takes what fits; nothing is
    overwritten, and the bytes come out in order."""
    ring = native.SampleRing(100)
    data = bytes(range(250))
    assert ring.write(data) == 100
    assert ring.write(data) == 0
    assert ring.advance(30) == 30
    assert ring.write(data[100:]) == 30            # wraps
    assert ring.peek(1000) == data[30:130]
    assert ring.read(1000) == data[30:130]
    assert ring.readable == 0
    ring.close()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_peek_into_caller_buffer(kind):
    x = (np.arange(40, dtype=np.float32) - 7).view(np.complex64)    # 20 samples
    ring = native.SampleRing(25 * 8)
    assert ring.write(x[:15]) == 15 * 8
    ring.advance(10 * 8)
    assert ring.write(x[15:]) == 5 * 8                               # wraps
    buf = np.zeros(12, np.complex64) if kind == "numpy" else torch.zeros(12, dtype=torch.complex64)
    assert ring.peek_into(buf, 10 * 8) == 10 * 8
    got = buf if kind == "numpy" else buf.numpy()
    np.testing.assert_array_equal(got[:10], x[10:])
    np.testing.assert_array_equal(got[10:], 0)
    assert ring.readable == 10 * 8                                   # not consumed
    with pytest.raises(ValueError, match="peek of"):
        ring.peek_into(buf, 13 * 8)
    with pytest.raises(ValueError, match="contiguous"):
        ring.peek_into(np.zeros((4, 4), np.complex64)[:, 0])
    ring.close()


def test_two_process_build_race_ends_with_one_library(tmp_path):
    """Two processes build into the same empty directory at the same
    moment: one compiles, the other waits on the lock and finds the
    library; one library, no partial file, and it loads."""
    build = tmp_path / "build"
    go = tmp_path / "go"
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from lora_tpu_torch import native\n"
        f"while not Path({str(go)!r}).exists(): time.sleep(0.005)\n"
        f"print(native.build(Path({str(build)!r})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    time.sleep(1.0)
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(
        ["host_io.lock", Path(paths.pop()).name])
    lib = native._load(str(build))
    h = lib.lt_ring_create(16)
    assert lib.lt_ring_capacity(h) == 16
    lib.lt_ring_destroy(h)


def _frames(mod):
    """Two frames of the port's (``mod`` the port's frames module) or JAX's
    (``lora_tpu.io.frames``) with the same fields."""
    out = []
    for i, payload in enumerate((b"\xde\xad\xbe\xef\x80\xec", b"\x42\x43\x44")):
        f = mod.Frame(phy_header=mod.PhyHeader(length=len(payload), has_mac_crc=1, cr=4),
                      payload=payload, snr=12.5 + i, channel=i, sample_index=1000 * i)
        f.tap_header.frequency = 868_100_000 + 200_000 * i
        f.tap_header.sf = 7 + i
        out.append(f)
    return out


@pytest.mark.parametrize("backend", ["native", "python", "auto"])
@pytest.mark.parametrize("layer", [LORATAP, LORAPHY, LORAMAC])
def test_udp_sink_to_server_round_trip(backend, layer):
    with LoRaUDPServer(port=0, timeout=5.0) as server:
        sink = MessageSocketSink("127.0.0.1", server.port, layer=layer, backend=backend)
        assert (sink._native is None) == (backend == "python")
        frames = _frames(pframes)
        sink.handle_all(frames)
        sink.close()
        got = server.get_payloads(2)
    assert got == [f.to_bytes(layer).hex().encode() for f in frames]


def test_udp_sources_receive(tmp_path):
    src_py = MessageSocketSource("127.0.0.1", 0)
    src_native = native.NativeUdpSource("127.0.0.1", 0)
    try:
        assert src_py.port > 0 and src_native.port > 0
        for port in (src_py.port, src_native.port):
            sink = native.NativeUdpSink("127.0.0.1", port)
            sink.send(b"\x01\x02\x03")
            sink.send(b"")
            sink.close()
        assert src_py.get(timeout=5.0) == b"\x01\x02\x03"
        assert src_native.poll(5000) == b"\x01\x02\x03"
        assert src_native.poll(5000) == b""
        assert src_native.poll(10) is None
    finally:
        src_py.close()
        src_native.close()


@pytest.mark.parametrize("backend", ["native", "python"])
def test_file_sink_bytes_equal_jax(tmp_path, backend):
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    for layer in (LORATAP, LORAMAC):
        sink = MessageFileSink(str(ours), layer=layer, backend=backend)
        sink.handle_all(_frames(pframes))
        sink.close()
        jsink = JFileSink(str(theirs), layer=layer, backend="python")
        jsink.handle_all(_frames(jframes))
        jsink.close()
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) > 40


def test_sink_options_refused():
    with pytest.raises(ValueError, match="backend"):
        MessageSocketSink(backend="ctypes")
    with pytest.raises(ValueError, match="backend"):
        MessageFileSink("/nonexistent/x", backend="ctypes")
    with pytest.raises(NotImplementedError, match="pymongo"):
        MessageMongoDBSink("mongodb://localhost:27017/")
    with pytest.raises(OSError):
        native.NativeUdpSink("not-an-ip", 1)
    with pytest.raises(OSError):
        native.NativeFileSink("/nonexistent-dir/frames.bin")

