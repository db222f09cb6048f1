"""The port's host library: the sample ring and the UDP and file sinks.

``host_io.cpp`` is compiled by ``g++`` at first use into
``lora_tpu_torch/build/libhost_io-<hash>.so`` and loaded with ``ctypes``
(a C interface, no PyTorch headers). The hash covers the source and the
flags, so an edited source is never served by a stale library. Builds are
serialised across processes by a file lock in the build directory, and the
library appears by an atomic rename, so concurrent first users (test
workers, say) end with one complete library. There is no quiet fallback:
a missing compiler or a failed build raises with the compiler's output.

- :class:`SampleRing`      <- GNU Radio's bounded stream buffers, with
  ``peek``/``advance`` for overlap-save streaming and ``peek_into`` a
  caller's buffer (a staging slot)
- :class:`NativeUdpSink`   <- lib/message_socket_sink_impl.cc
- :class:`NativeUdpSource` <- lib/message_socket_source_impl.cc
- :class:`NativeFileSink`  <- lib/message_file_sink_impl.cc
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "host_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")

_vp, _long, _int = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "lt_udp_sink_open": ([ctypes.c_char_p, _int], _vp),
    "lt_udp_sink_send": ([_vp, _vp, _long], _long),
    "lt_udp_sink_close": ([_vp], None),
    "lt_udp_source_open": ([ctypes.c_char_p, _int], _vp),
    "lt_udp_source_port": ([_vp], _int),
    "lt_udp_source_poll": ([_vp, _vp, _long, _int], _long),
    "lt_udp_source_close": ([_vp], None),
    "lt_file_sink_open": ([ctypes.c_char_p], _vp),
    "lt_file_sink_write": ([_vp, _vp, _long], _long),
    "lt_file_sink_close": ([_vp], None),
    "lt_ring_create": ([_long], _vp),
    "lt_ring_capacity": ([_vp], _long),
    "lt_ring_readable": ([_vp], _long),
    "lt_ring_write": ([_vp, _vp, _long], _long),
    "lt_ring_read": ([_vp, _vp, _long], _long),
    "lt_ring_peek": ([_vp, _vp, _long], _long),
    "lt_ring_advance": ([_vp, _long], _long),
    "lt_ring_destroy": ([_vp], None),
}


def gxx() -> str:
    """The C++ compiler: ``$CXX`` if set, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or not shutil.which(cxx):
        raise RuntimeError(f"no C++ compiler ({cxx or 'g++'} not found): the host "
                           f"library lora_tpu_torch/native/host_io.cpp needs g++")
    return cxx


def library_path(build_dir: Path) -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"libhost_io-{h}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``host_io.cpp`` into ``build_dir`` (the package's ``build/``
    by default) unless its current library is there; returns the
    library's path. One process compiles at a time (an exclusive lock on
    ``build_dir/host_io.lock``); a process that waited finds the library
    built. Raises with the compiler's output if the build fails."""
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    path = library_path(build_dir)
    if path.exists():
        return path
    with open(build_dir / "host_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if path.exists():
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx(), *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)   # atomic: a loader never sees half a file
    return path


@functools.cache
def _load(build_dir: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(Path(build_dir))))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def load() -> ctypes.CDLL:
    """The host library, built into :data:`BUILD_DIR` if needed."""
    return _load(str(BUILD_DIR))


def _span(buf) -> tuple:
    """``(address, bytes)`` of a contiguous buffer on the host: bytes, a
    numpy array, or a CPU torch tensor (pinned or not)."""
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, np.uint8)
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("the buffer must be C-contiguous")
        return buf.ctypes.data, buf.nbytes
    if buf.device.type != "cpu" or not buf.is_contiguous():
        raise ValueError("the buffer must be a contiguous tensor on the host")
    return buf.data_ptr(), buf.numel() * buf.element_size()


class SampleRing:
    """SPSC byte ring carrying packed IQ between producer and dispatcher.

    ``peek``/``advance`` implement overlap-save: the dispatcher peeks
    ``block + halo`` bytes but only advances ``block``, so the next block
    re-reads the halo. ``peek_into`` writes the peeked bytes into a
    caller's buffer (one copy, ring to staging)."""

    def __init__(self, capacity_bytes: int):
        self._lib = load()
        self._h = self._lib.lt_ring_create(int(capacity_bytes))

    @property
    def capacity(self) -> int:
        return int(self._lib.lt_ring_capacity(self._h))

    @property
    def readable(self) -> int:
        return int(self._lib.lt_ring_readable(self._h))

    def write(self, data) -> int:
        """Copy ``data`` (bytes, or a contiguous array) in, as much as fits;
        returns the bytes accepted."""
        addr, n = _span(data)
        return int(self._lib.lt_ring_write(self._h, addr, n))

    def read(self, n: int) -> bytes:
        buf = np.empty(int(n), np.uint8)
        return buf[: self._lib.lt_ring_read(self._h, buf.ctypes.data, buf.nbytes)].tobytes()

    def peek(self, n: int) -> bytes:
        buf = np.empty(int(n), np.uint8)
        return buf[: self.peek_into(buf)].tobytes()

    def peek_into(self, buf, n: Optional[int] = None) -> int:
        """Copy up to ``n`` bytes (default: the buffer's size) from the head
        into ``buf`` without consuming them; returns the bytes copied."""
        addr, size = _span(buf)
        n = size if n is None else int(n)
        if n > size:
            raise ValueError(f"peek of {n} bytes into a buffer of {size}")
        return int(self._lib.lt_ring_peek(self._h, addr, n))

    def advance(self, n: int) -> int:
        return int(self._lib.lt_ring_advance(self._h, int(n)))

    def close(self) -> None:
        if self._h:
            self._lib.lt_ring_destroy(self._h)
            self._h = None


class NativeUdpSink:
    """UDP datagram-per-frame sink (native ``sendto``)."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 40868):
        self._lib = load()
        self._h = self._lib.lt_udp_sink_open(ip.encode(), int(port))
        if not self._h:
            raise OSError(f"cannot open UDP sink to {ip}:{port}")

    def send(self, data: bytes) -> int:
        addr, n = _span(data)
        return int(self._lib.lt_udp_sink_send(self._h, addr, n))

    def close(self) -> None:
        if self._h:
            self._lib.lt_udp_sink_close(self._h)
            self._h = None


class NativeUdpSource:
    """Background-thread UDP receiver with a bounded drop-oldest queue.
    ``port=0`` binds a port of the kernel's choice (:attr:`port`)."""

    def __init__(self, addr: str = "0.0.0.0", port: int = 40868):
        self._lib = load()
        self._h = self._lib.lt_udp_source_open(addr.encode(), int(port))
        if not self._h:
            raise OSError(f"cannot bind UDP source {addr}:{port}")
        self._buf = np.empty(65536, np.uint8)

    @property
    def port(self) -> int:
        return int(self._lib.lt_udp_source_port(self._h))

    def poll(self, timeout_ms: int = 200) -> Optional[bytes]:
        n = self._lib.lt_udp_source_poll(self._h, self._buf.ctypes.data, self._buf.nbytes,
                                         int(timeout_ms))
        if n == 0:
            return None
        if n == -2:  # empty datagram
            return b""
        return self._buf[:n].tobytes()

    def close(self) -> None:
        if self._h:
            self._lib.lt_udp_source_close(self._h)
            self._h = None


class NativeFileSink:
    """Append-only frame file sink, flushed per write."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.lt_file_sink_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, data: bytes) -> int:
        addr, n = _span(data)
        return int(self._lib.lt_file_sink_write(self._h, addr, n))

    def close(self) -> None:
        if self._h:
            self._lib.lt_file_sink_close(self._h)
            self._h = None
