"""Sample-level debugging: the live scope bridge and raw sample taps.

The port's own copy of ``lora_tpu/debugger.py``, host code with no device:

- :class:`SampleDebugger` <- the reference's ``lib/debugger.cc`` /
  ``include/lora/debugger.h``: buffers complex samples and ships them over
  a UNIX stream socket to an analyzer. The wire format is the reference's
  (``debugger.h:40-43``): a packed 5-byte header ``{uint32 length_be,
  uint8 draw_over}`` and then ``length`` bytes of complex64 samples, so
  the reference's ``apps/grlora_analyze.py`` reads it unchanged, and JAX's
  analyzer too.
- :class:`AnalyzerServer` <- the listening half of
  ``apps/grlora_analyze.py:48-120``: accepts a debugger connection and
  yields the sample buffers.
- :func:`live_analyze` <- the matplotlib scope of ``grlora_analyze.py``
  (amplitude and instantaneous frequency, ``draw_over`` overlays), or a
  line of statistics a buffer where matplotlib is missing.
- :func:`dump_samples` <- the reference's ``GRLORA_DEBUG`` binary dumps
  (``lib/decoder_impl.cc:167-168``).

The default socket and dump directory are in the system's temporary
directory (``/tmp`` unless ``TMPDIR`` says otherwise), where the
reference puts them.
"""

from __future__ import annotations

import os
import socket
import struct
import tempfile
from typing import Callable, Iterator, Optional

import numpy as np

DEFAULT_SOCK = os.path.join(tempfile.gettempdir(), "gr_lora.sock")
_HDR = struct.Struct("!IB")  # uint32 length (network order) + bool draw_over


class SampleDebugger:
    """Client side: buffer samples, send them to an attached analyzer
    (the reference's ``attach/detach/store_samples/analyze_samples``,
    include/lora/debugger.h:33-37). Unattached, every call is a no-op."""

    def __init__(self) -> None:
        self._sock: Optional[socket.socket] = None
        self._samples: list = []

    @property
    def attached(self) -> bool:
        return self._sock is not None

    def attach(self, path: str = DEFAULT_SOCK) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(path)
        except OSError:
            # the reference ignores a missing analyzer (debugger.cc:31-35)
            s.close()
            return
        self._sock = s

    def detach(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def store_samples(self, samples) -> None:
        if self._sock is not None:
            self._samples.append(np.asarray(samples, dtype=np.complex64))

    def analyze_samples(self, clear: bool = True, draw_over: bool = False) -> None:
        if self._sock is None:
            return
        buf = (np.concatenate(self._samples) if self._samples
               else np.zeros(0, np.complex64)).tobytes()
        try:
            self._sock.sendall(_HDR.pack(len(buf), int(draw_over)) + buf)
        except OSError:
            self.detach()
            return
        if clear:
            self._samples.clear()


class AnalyzerServer:
    """Listening side: accept one debugger client, iterate its buffers as
    ``(samples, draw_over)``."""

    def __init__(self, path: str = DEFAULT_SOCK):
        self.path = path
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(path)
        self._server.listen(1)
        self._conn: Optional[socket.socket] = None

    def accept(self, timeout: Optional[float] = None) -> None:
        self._server.settimeout(timeout)
        self._conn, _ = self._server.accept()

    def _recv_exact(self, n: int) -> bytes:
        if self._conn is None:
            raise ConnectionError("no debugger connected")
        chunks = []
        while n:
            b = self._conn.recv(n)
            if not b:
                raise ConnectionError("debugger disconnected")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def __iter__(self) -> Iterator[tuple]:
        while True:
            try:
                length, draw_over = _HDR.unpack(self._recv_exact(_HDR.size))
                payload = self._recv_exact(length)
            except (ConnectionError, OSError):
                return
            yield np.frombuffer(payload, dtype=np.complex64), bool(draw_over)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self._server.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def dump_samples(name: str, samples, directory: Optional[str] = None) -> str:
    """Append raw complex64 samples to ``<directory>/<name>`` (default: the
    temporary directory), the reference's tap files. Returns the path."""
    path = os.path.join(tempfile.gettempdir() if directory is None else directory, name)
    with open(path, "ab") as f:
        f.write(np.asarray(samples, dtype=np.complex64).tobytes())
    return path


def live_analyze(path: str = DEFAULT_SOCK, on_buffer: Optional[Callable] = None,
                 max_buffers: Optional[int] = None) -> int:
    """Run the analyzer scope: with matplotlib, |x| and the instantaneous
    frequency of each buffer (overlaid when ``draw_over``); without it, a
    line of statistics a buffer. ``on_buffer(samples, draw_over)`` replaces
    both. Returns the number of buffers processed."""
    try:
        import matplotlib

        matplotlib.use(os.environ.get("MPLBACKEND", "Agg"))
        import matplotlib.pyplot as plt
    except ImportError:   # a host plot, not a device: print statistics instead
        plt = None

    server = AnalyzerServer(path)
    print(f"listening on {path} ...")
    server.accept()
    n = 0
    try:
        for samples, draw_over in server:
            n += 1
            if on_buffer is not None:
                on_buffer(samples, draw_over)
            elif plt is not None and len(samples):
                ifreq = np.diff(np.unwrap(np.angle(samples)))
                if not draw_over:
                    plt.clf()
                ax1 = plt.subplot(211)
                ax1.plot(np.abs(samples))
                ax1.set_ylabel("|x|")
                ax2 = plt.subplot(212)
                ax2.plot(ifreq)
                ax2.set_ylabel("inst. freq")
                if matplotlib.get_backend() != "Agg":
                    plt.pause(0.001)
            else:
                print(f"buffer {n}: {len(samples)} samples, "
                      f"mean |x| = {np.abs(samples).mean() if len(samples) else 0:.4g}, "
                      f"draw_over={draw_over}")
            if max_buffers is not None and n >= max_buffers:
                break
    finally:
        server.close()
    return n
