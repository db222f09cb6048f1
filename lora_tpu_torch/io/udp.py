"""UDP frame transport: socket sink/source + test-side UDP server.

Host-side equivalents of the reference's three message blocks, on the
port's :class:`~lora_tpu_torch.io.frames.Frame` and its own host library
(:mod:`lora_tpu_torch.native`):

- :class:`MessageSocketSink` <- ``lib/message_socket_sink_impl.cc``
  (datagram per frame, layer stripping before send)
- :class:`MessageSocketSource` <- ``lib/message_socket_source_impl.cc``
  (background receive thread re-publishing datagrams to a callback/queue)
- :class:`LoRaUDPServer` <- ``python/lorasocket.py`` (test harness side,
  returns hexlified payloads)
"""

from __future__ import annotations

import binascii
import queue
import socket
import threading
from typing import Callable, List, Optional

from .frames import LORATAP, Frame

BACKENDS = ("auto", "native", "python")


class MessageSocketSink:
    """Sends each decoded frame as one UDP datagram.

    ``layer``: LORATAP (0) full frame, LORAPHY (1) strip loratap header,
    LORAMAC (2) strip loratap+phy headers and MAC CRC (reference
    message_socket_sink_impl.cc:97-116; default endpoint 127.0.0.1:40868).

    ``backend``: ``"native"`` (and ``"auto"``, which is the same) sends
    through the port's C++ ``sendto`` (:class:`~lora_tpu_torch.native.
    NativeUdpSink`) and raises if the host library cannot be built;
    ``"python"`` uses a Python socket.
    """

    def __init__(self, ip: str = "127.0.0.1", port: int = 40868,
                 layer: int = LORATAP, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
        self.addr = (ip, port)
        self.layer = layer
        self._native = None
        self.sock = None
        if backend == "python":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        else:
            from ..native import NativeUdpSink

            self._native = NativeUdpSink(ip, port)

    def handle(self, frame: Frame) -> None:
        data = frame.to_bytes(self.layer)
        if self._native is not None:
            self._native.send(data)
        else:
            self.sock.sendto(data, self.addr)

    def handle_all(self, frames) -> None:
        for f in frames:
            self.handle(f)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        if self.sock is not None:
            self.sock.close()


class MessageSocketSource:
    """Background thread receiving UDP datagrams, publishing to a queue or
    callback (reference message_socket_source_impl.cc:49-97). ``port=0``
    binds a port of the kernel's choice (:attr:`port`)."""

    def __init__(self, addr: str = "0.0.0.0", port: int = 40868,
                 callback: Optional[Callable[[bytes], None]] = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((addr, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.queue: "queue.Queue[bytes]" = queue.Queue()
        self._callback = callback
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            if self._callback is not None:
                self._callback(data)
            else:
                self.queue.put(data)

    def get(self, timeout: Optional[float] = None) -> bytes:
        return self.queue.get(timeout=timeout)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.sock.close()


class LoRaUDPServer:
    """Test-side UDP listener returning hexlified payloads
    (reference python/lorasocket.py:4-34). ``port=0`` binds a port of the
    kernel's choice (:attr:`port`)."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 40868, timeout: float = 10.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((ip, port))
        self.sock.settimeout(timeout)
        self.port = self.sock.getsockname()[1]

    def get_payloads(self, number_of_payloads: int) -> List[bytes]:
        out: List[bytes] = []
        for _ in range(number_of_payloads):
            try:
                data = self.sock.recvfrom(65535)[0]
            except OSError as e:  # a timeout: the reference prints and continues
                print(e)
                continue
            if data:
                out.append(binascii.hexlify(data))
        return out

    def close(self):
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
