"""File frame sink, and the MongoDB sink refused by name.

- :class:`MessageFileSink` <- reference ``lib/message_file_sink_impl.cc``
  (append raw frame bytes, flush per message).
- :class:`MessageMongoDBSink` <- reference ``python/message_mongodb_sink.py``:
  not ported. It needs ``pymongo``, which this installation does not have,
  so constructing it raises.
"""

from __future__ import annotations

from .frames import LORATAP, Frame

BACKENDS = ("auto", "native", "python")


class MessageFileSink:
    """Appends raw frame bytes to a binary file, flushing per message.

    ``backend``: ``"native"`` (and ``"auto"``, the same) writes through the
    port's C++ writer (:class:`~lora_tpu_torch.native.NativeFileSink`) and
    raises if the host library cannot be built; ``"python"`` uses Python
    file IO.
    """

    def __init__(self, path: str, layer: int = LORATAP, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
        self.path = path
        self.layer = layer
        self._native = None
        self._f = None
        if backend == "python":
            self._f = open(path, "ab")
        else:
            from ..native import NativeFileSink

            self._native = NativeFileSink(path)

    def handle(self, frame: Frame) -> None:
        data = frame.to_bytes(self.layer)
        if self._native is not None:
            self._native.write(data)
        else:
            self._f.write(data)
            self._f.flush()

    def handle_all(self, frames) -> None:
        for f in frames:
            self.handle(f)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        if self._f is not None:
            self._f.close()


class MessageMongoDBSink:
    """The reference's MongoDB frame sink: not ported (needs ``pymongo``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MessageMongoDBSink is not ported: it needs pymongo, which is not "
            "installed; use MessageFileSink or MessageSocketSink")
