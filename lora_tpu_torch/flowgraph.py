"""Declarative flowgraphs: the GRC layer of the reference, on the card.

The port of ``lora_tpu/flowgraph.py``. The reference ships GNU Radio
Companion artifacts: block descriptors (``grc/*.block.yml``) and flowgraph
files (``apps/lora_receive_file.grc``, ``apps/lora_receive_realtime.grc``)
wiring ``file_source | uhd_usrp_source -> throttle -> lora_receiver ->
sinks`` without code. This module reads the same small YAML format as the
JAX package (``options`` / ``variables`` / ``blocks`` / ``connections``;
``examples/*.yml`` run unchanged), keeps the same typed block registry,
whose descriptors equal JAX's, and runs a graph as chunked streaming
through the port's receivers:

.. code-block:: yaml

    variables: {samp_rate: 1e6, capture_freq: 868.0e6, offset: 100e3}
    blocks:
    - {name: src, id: file_source, parameters: {file: capture.cf32}}
    - name: rx
      id: lora_receiver
      parameters: {samp_rate: samp_rate, center_freq: capture_freq,
                   channel_list: [capture_freq + offset], sf: 7}
    - {name: udp, id: message_socket_sink, parameters: {port: 40868}}
    connections:
    - [src, '0', rx, '0']
    - [rx, frames, udp, in]

Parameter values are expressions over ``variables`` (an arithmetic subset
of what GRC evaluates). Stream connections (``'0'`` ports) carry IQ,
message connections (``frames``/``in``) decoded frames, as the
reference's typed streams and PMT ports split them.

``StreamingLoRaReceiver`` channelizes on the receiver's device by one of
three routes, chosen as JAX chooses them: a dense channel grid (two or
more channels on the ``samp_rate/M`` grid, decimation ``M >= 8``, dense
engine) goes through the polyphase filterbank inside
:class:`~lora_tpu_torch.stream.WidebandStreamingReceiver`; two or more
channels off that grid through a mixer bank and a decimating FIR over
fixed blocks of ``4096 * decimation`` samples (the mixer table built in
float64 on the host); one channel through the same FIR with the filter's
tail and the decimation phase carried from chunk to chunk. The channel
streams of the last two routes come back to the host and feed the port's
:class:`~lora_tpu_torch.stream.StreamingReceiver` (dense engine), or are
buffered and decoded at ``flush()`` by the port's facade (golden and
parity engines), as JAX's are. ``Flowgraph``, ``run_flowgraph`` and the
two receiver blocks take ``device`` (``None``: the card; ``"cpu"`` for the
CPU); it is not a graph parameter.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .channelizer import channelize_list_planes, lora_channel_taps, make_mixer_planes
from .config import LoRaConfig
from .device import resolve_device
from .io.frames import Frame
from .ops.xfer import pack_iq


# --------------------------------------------------------------------------
# safe expression evaluation (GRC evaluates parameters as Python; this is
# the arithmetic subset)
# --------------------------------------------------------------------------

_ALLOWED_CALLS = {"int": int, "float": float, "abs": abs, "min": min,
                  "max": max, "round": round, "len": len}


def safe_eval(expr: Any, variables: Dict[str, Any]):
    """Evaluate a parameter expression: numbers, strings, bools, lists,
    variable names, arithmetic and a handful of builtins. Anything else is
    kept as the verbatim string (a path, an address); an unknown name
    raises ``NameError``."""
    if isinstance(expr, (int, float, bool, bytes)) or expr is None:
        return expr
    if isinstance(expr, (list, tuple)):
        return [safe_eval(e, variables) for e in expr]
    s = str(expr)

    def _eval(node):
        if isinstance(node, ast.Expression):
            return _eval(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in variables:
                return variables[node.id]
            if node.id in ("True", "False", "None"):
                return {"True": True, "False": False, "None": None}[node.id]
            raise NameError(f"unknown variable {node.id!r} in {s!r}")
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
                          ast.Pow)):
            a, b = _eval(node.left), _eval(node.right)
            return {
                ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                ast.Mult: lambda: a * b, ast.Div: lambda: a / b,
                ast.FloorDiv: lambda: a // b, ast.Mod: lambda: a % b,
                ast.Pow: lambda: a ** b,
            }[type(node.op)]()
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                        (ast.USub, ast.UAdd, ast.Not)):
            v = _eval(node.operand)
            return (-v if isinstance(node.op, ast.USub)
                    else +v if isinstance(node.op, ast.UAdd) else not v)
        if isinstance(node, (ast.List, ast.Tuple)):
            return [_eval(e) for e in node.elts]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _ALLOWED_CALLS and not node.keywords):
            return _ALLOWED_CALLS[node.func.id](*[_eval(a) for a in node.args])
        raise ValueError(f"disallowed expression {s!r}")

    try:
        tree = ast.parse(s, mode="eval")
    except SyntaxError:
        return s  # a plain string value (e.g. a file path)
    try:
        return _eval(tree)
    except NameError:
        raise
    except ValueError:
        # strings like '127.0.0.1' parse but do not evaluate: kept verbatim
        return s


# --------------------------------------------------------------------------
# block registry and descriptors (<- grc/*.block.yml)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Param:
    id: str
    dtype: str
    default: Any = None
    label: str = ""


@dataclasses.dataclass
class BlockSpec:
    id: str
    label: str
    kind: str  # 'source' | 'stream' | 'receiver' | 'sink' | 'msg_source'
    params: List[Param]
    make: Callable[..., Any]
    doc: str = ""

    def descriptor(self) -> dict:
        """The GRC-style block descriptor (grc/*.block.yml's fields)."""
        return {
            "id": f"lora_{self.id}",
            "label": self.label,
            "category": "[LoRa TPU]",
            "kind": self.kind,
            "parameters": [
                {"id": p.id, "label": p.label or p.id.replace("_", " "),
                 "dtype": p.dtype, "default": p.default}
                for p in self.params
            ],
            "documentation": self.doc.strip(),
        }


BLOCKS: Dict[str, BlockSpec] = {}


def _register(spec: BlockSpec) -> BlockSpec:
    BLOCKS[spec.id] = spec
    return spec


def block_descriptors() -> List[dict]:
    """Every block's descriptor, the set ``grc/*.block.yml`` corresponds to."""
    return [b.descriptor() for b in BLOCKS.values()]


# --------------------------------------------------------------------------
# sources
# --------------------------------------------------------------------------

class FileSource:
    """cf32 file, or a SigMF trace by its ``.sigmf-meta``
    (<- blocks_file_source in apps/lora_receive_file.grc:119)."""

    def __init__(self, file: str, repeat: bool = False, chunk_samples: int = 1 << 18):
        if str(file).endswith(".sigmf-meta"):
            from .io.sigmf import read_trace

            self._all = read_trace(file).samples
            self._file = None
        else:
            self._all = None
            self._file = open(file, "rb")
        self.repeat = bool(repeat)
        self.chunk = int(chunk_samples)
        self._pos = 0

    def chunks(self):
        while True:
            if self._all is not None:
                if self._pos >= len(self._all):
                    if not self.repeat:
                        break
                    self._pos = 0
                yield self._all[self._pos:self._pos + self.chunk]
                self._pos += self.chunk
            else:
                raw = self._file.read(self.chunk * 8)
                if not raw:
                    if not self.repeat:
                        break
                    self._file.seek(0)
                    continue
                yield np.frombuffer(raw, dtype=np.complex64)

    def close(self):
        if self._file:
            self._file.close()


class StdinSource:
    """cf32 on stdin: pipe any capture or SDR tool in
    (``rtl_sdr - | ... | python -m lora_tpu_torch.cli flowgraph rt.yml``)."""

    def __init__(self, chunk_samples: int = 1 << 17):
        self.chunk = int(chunk_samples)

    def chunks(self):
        f = sys.stdin.buffer
        while True:
            raw = f.read(self.chunk * 8)
            if not raw:
                break
            n = len(raw) // 8 * 8
            yield np.frombuffer(raw[:n], dtype=np.complex64)

    def close(self):
        pass


class UdpIqSource:
    """cf32 IQ in UDP datagrams: the live-SDR ingest in place of
    uhd_usrp_source in lora_receive_realtime.grc (each datagram raw cf32).
    ``port=0`` binds a port of the kernel's choice."""

    def __init__(self, addr: str = "0.0.0.0", port: int = 40900, timeout: float = 5.0,
                 max_samples: Optional[int] = None):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((addr, int(port)))
        self.sock.settimeout(timeout)
        self.max_samples = max_samples

    def chunks(self):
        import socket as _socket

        seen = 0
        while self.max_samples is None or seen < self.max_samples:
            try:
                raw, _ = self.sock.recvfrom(1 << 16)
            except (_socket.timeout, OSError):
                break
            if not raw:
                break
            n = len(raw) // 8 * 8
            x = np.frombuffer(raw[:n], dtype=np.complex64)
            seen += len(x)
            yield x

    def close(self):
        self.sock.close()


class Throttle:
    """Pace chunks to ``samp_rate`` samples a second (<- blocks_throttle,
    apps/lora_receive_file.grc:141): replaying a capture as if live."""

    def __init__(self, samp_rate: float):
        self.samp_rate = float(samp_rate)
        self._t0 = None
        self._sent = 0

    def pace(self, n: int) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._sent += n
        due = self._t0 + self._sent / self.samp_rate
        if due > now:
            time.sleep(due - now)


# --------------------------------------------------------------------------
# sinks (frame consumers; each has .handle(frame))
# --------------------------------------------------------------------------

class FramePrintSink:
    """Hex print to stdout, the decoder's own printout in the reference
    (lib/decoder_impl.cc:872 via utilities.h print_vector_hex)."""

    def __init__(self, layer: int = 1, stream=None):
        self.layer = int(layer)
        self.stream = stream or sys.stdout

    def handle(self, frame: Frame) -> None:
        print(" ".join(f"{b:02x}" for b in frame.to_bytes(self.layer)), file=self.stream)


class FrameCollectSink:
    """In-memory collector; ``Flowgraph.run()`` returns its frames."""

    def __init__(self):
        self.frames: List[Frame] = []

    def handle(self, frame: Frame) -> None:
        self.frames.append(frame)


# --------------------------------------------------------------------------
# the receiver block: chunk-continuous channelizer + per-channel decoders
# --------------------------------------------------------------------------

def _to_host(y: torch.Tensor) -> List[np.ndarray]:
    """Channel planes ``[C, 2, m]`` -> host complex64 streams."""
    y = y.cpu().numpy()
    return list((y[:, 0] + 1j * y[:, 1]).astype(np.complex64))


class StreamingLoRaReceiver:
    """Streaming form of :class:`lora_tpu_torch.receiver.LoRaReceiver` on
    ``device`` (``None``: the card): chunk-continuous channelization (the
    three routes of the module notes; ``route`` names the one taken)
    feeding per-channel :class:`~lora_tpu_torch.stream.StreamingReceiver`
    instances (dense engine) or a buffered golden or parity decode."""

    def __init__(self, samp_rate: float, center_freq: float,
                 channel_list: Sequence[float], bandwidth: float = 125e3,
                 sf: int = 7, implicit: bool = False, cr: int = 4,
                 crc: bool = True, reduced_rate: bool = False,
                 conj: bool = False, decimation: int = 1,
                 disable_channelization: bool = False,
                 disable_drift_correction: bool = False,
                 engine: str = "dense", block_symbols: int = 512,
                 max_candidates: int = 8, max_symbols: int = 48,
                 auto_cfo: bool = False, device=None):
        if engine not in ("dense", "parity", "golden"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        self.samp_rate = float(samp_rate)
        self.center_freq = float(center_freq)
        self.channel_list = [float(f) for f in (channel_list or [center_freq])]
        self.decimation = int(decimation)
        if float(decimation) != self.decimation:
            raise ValueError(
                "fractional decimation is not streamable; use "
                "`lora_tpu_torch.cli decode-file` (the fractional_resampler path)")
        self.decimation = max(1, self.decimation)
        self.disable_channelization = bool(disable_channelization)
        self.conj = bool(conj)
        self.engine = engine
        self.config = LoRaConfig(
            sf=int(sf), cr=int(cr), bandwidth=float(bandwidth),
            samp_rate=self.samp_rate / self.decimation,
            implicit=bool(implicit), crc=bool(crc),
            reduced_rate=bool(reduced_rate), conj=False,  # conj applied here
            disable_drift_correction=bool(disable_drift_correction),
        )
        self._taps = (None if disable_channelization
                      else lora_channel_taps(self.samp_rate, float(bandwidth)))
        self._offsets = [f - self.center_freq for f in self.channel_list]
        self._tail = np.zeros(0, np.complex64)  # raw carry (ntaps - 1)
        self._raw_index = 0          # absolute raw-sample index of the chunk head
        self._filt_count = 0         # full-rate filtered samples produced so far
        self.sinks: List[Any] = []
        # mid-stream CFO loop (reference controller semantics,
        # lib/controller_impl.cc:52-57 -> channelizer_impl.cc:68-71: d_cfo
        # += cfo, retune the translating FIR while the graph runs): each
        # batch's last frame retunes its channel's mixer from the next
        # chunk on. Off by default, as the reference's decoder-side
        # publisher is (decoder_impl.cc:774-776)
        self.auto_cfo = bool(auto_cfo)
        self.cfo = [0.0 for _ in self.channel_list]

        # route: the polyphase filterbank, for a dense grid of channels
        self._wb_stream = None
        self._wb_chan_to_ci = {}
        if (engine == "dense" and not disable_channelization and not self.auto_cfo
                and len(self._offsets) >= 2 and self.decimation >= 8):
            M = self.decimation
            spacing = self.samp_rate / M
            ks = [off / spacing for off in self._offsets]
            if all(abs(k - round(k)) < 1e-6 for k in ks):
                from .stream import WidebandStreamingReceiver
                from .wideband import WidebandReceiver

                active = [int(round(k)) % M for k in ks]
                self._wb_chan_to_ci = {a: ci for ci, a in enumerate(active)}
                wb = WidebandReceiver(
                    self.config, M, active_channels=sorted(set(active)),
                    pool=4 * len(active), max_candidates=max_candidates,
                    max_symbols=max_symbols, device=self.device)
                self._wb_stream = WidebandStreamingReceiver(wb, block_symbols=block_symbols)

        # route: a mixer bank + FIR over fixed blocks, for two or more
        # channels off the grid (irregular offsets, decimation < 8,
        # auto_cfo, the golden and parity engines)
        self._bank_pending = np.zeros(0, np.complex64)
        self._bank_head = 0
        self._bank_key = None
        self._bank_table = None
        self._bank_block = 4096 * self.decimation
        if self._wb_stream is not None:
            self.route = "pfb"
        elif self._taps is None:
            self.route = "none"
        elif len(self._offsets) >= 2:
            self.route = "mixer_bank"
        elif self._offsets[0] == 0.0 and self.decimation == 1 and not self.auto_cfo:
            # pass-through; with auto_cfo the filter always runs, so the
            # accumulated CFO retunes the mixer
            self.route = "none"
        else:
            self.route = "fir"

        if self._wb_stream is not None:
            self._streams = None
            self._buffered = None
        elif engine == "dense":
            from .rx.dense import DenseReceiver
            from .stream import StreamingReceiver

            self._streams = [
                StreamingReceiver(
                    DenseReceiver(self.config, max_candidates=max_candidates,
                                  max_symbols=max_symbols, device=self.device),
                    block_symbols=block_symbols)
                for _ in self._offsets
            ]
            self._buffered = None
        else:
            self._streams = None
            self._buffered = [np.zeros(0, np.complex64) for _ in self._offsets]

    # -- chunk-continuous channelizer ---------------------------------------
    def _bank_mixers(self, offs_hz: np.ndarray, length: int) -> torch.Tensor:
        """The mixer bank's table ``[C, 2, length]`` on the device, from
        sample 0, cached until a CFO retune changes the offsets."""
        key = (tuple(offs_hz.tolist()), length)
        if self._bank_key != key:
            self._bank_table = torch.as_tensor(
                make_mixer_planes(offs_hz, self.samp_rate, length), device=self.device)
            self._bank_key = key
        return self._bank_table

    def _channelize_bank(self, x: np.ndarray, final: bool = False) -> List[np.ndarray]:
        """The mixer-bank route: blocks of ``4096 * decimation`` outputs'
        worth of input (plus the filter's ``ntaps - 1``), each mixed by the
        cached table times its channels' phase at the block head (float64
        on the host), filtered and decimated on the device; with ``final``
        the partial last block is zero-padded and its outputs trimmed."""
        ntaps = len(self._taps)
        B = self._bank_block
        L = B + ntaps - 1
        if len(x):
            self._bank_pending = np.concatenate([self._bank_pending, x])
        outs: List[List[np.ndarray]] = [[] for _ in self._offsets]
        offs = np.asarray([o + c for o, c in zip(self._offsets, self.cfo)], dtype=np.float64)
        while (len(self._bank_pending) >= L
               or (final and len(self._bank_pending) >= ntaps)):
            raw = self._bank_pending[:L]
            # the head advances by the samples consumed, so a push after a
            # final (padded) flush resumes with the right mixer phase
            n_raw = len(raw)
            n_valid = None
            if n_raw < L:
                n_valid = -(-(n_raw - ntaps + 1) // self.decimation)
                raw = np.pad(raw, (0, L - n_raw))
            ph = np.exp(-2j * np.pi * ((offs / self.samp_rate * float(self._bank_head)) % 1.0))
            phase = torch.as_tensor(np.stack([ph.real, ph.imag], axis=1).astype(np.float32),
                                    device=self.device)
            table = self._bank_mixers(offs, L)
            pr, pi = phase[:, 0, None], phase[:, 1, None]
            mixer = torch.stack([pr * table[:, 0] - pi * table[:, 1],
                                 pr * table[:, 1] + pi * table[:, 0]], dim=1)
            y = channelize_list_planes(pack_iq(raw, device=self.device), self._taps, mixer,
                                       self.decimation)
            if n_valid is not None:
                y = y[..., :max(n_valid, 0)]
                self._bank_pending = self._bank_pending[:0]
                self._bank_head += n_raw
            else:
                self._bank_pending = self._bank_pending[B:]
                self._bank_head += B
            for ci, yc in enumerate(_to_host(y)):
                outs[ci].append(yc)
        return [np.concatenate(o) if o else np.zeros(0, np.complex64) for o in outs]

    def _channelize_one(self, x: np.ndarray) -> List[np.ndarray]:
        """The one-channel route: the filter's last ``ntaps - 1`` inputs
        carried to the next chunk, and the decimation phase kept across
        chunks, so chunked output equals one call over the whole stream."""
        ntaps = len(self._taps)
        raw = np.concatenate([self._tail, x])
        head = self._raw_index - len(self._tail)
        self._tail = raw[max(0, len(raw) - (ntaps - 1)):]
        self._raw_index += len(x)
        if len(raw) < ntaps:
            return [np.zeros(0, np.complex64)]
        p = (-self._filt_count) % self.decimation
        self._filt_count += len(raw) - ntaps + 1
        if len(raw) - p < ntaps:
            return [np.zeros(0, np.complex64)]
        mixer = make_mixer_planes([self._offsets[0] + self.cfo[0]], self.samp_rate,
                                  len(raw) - p, start=head + p)
        y = channelize_list_planes(pack_iq(raw[p:], device=self.device), self._taps, mixer,
                                   self.decimation)
        return _to_host(y)

    def _channelize(self, x: np.ndarray) -> List[np.ndarray]:
        if self.route == "none":
            return [x[::self.decimation] for _ in self._offsets]
        if self.route == "mixer_bank":
            return self._channelize_bank(x)
        return self._channelize_one(x)

    # -- streaming API --------------------------------------------------------
    def push(self, x: np.ndarray) -> List[Frame]:
        x = np.asarray(x, dtype=np.complex64)
        if self.conj:
            x = np.conj(x)
        if self._wb_stream is not None:
            frames = self._map_wb(self._wb_stream.push(x))
        else:
            frames = self._feed(self._channelize(x))
        self._emit(frames)
        return frames

    def _feed(self, chans: List[np.ndarray]) -> List[Frame]:
        """Route channelized chunks into the per-channel decoders."""
        frames: List[Frame] = []
        for ci, ch in enumerate(chans):
            if not len(ch):
                continue
            if self._streams is not None:
                new = self._streams[ci].push(ch)
                for f in new:
                    f.channel = ci
                    frames.append(f)
                if self.auto_cfo and new:
                    # every frame of the batch was channelized with the same
                    # mixer, so each .cfo is a residual against it; the last
                    # says where the carrier is now
                    self.apply_cfo(float(new[-1].cfo), ci)
            else:
                self._buffered[ci] = np.concatenate([self._buffered[ci], ch])
        return frames

    def _map_wb(self, frames: List[Frame]) -> List[Frame]:
        """PFB channel indices -> channel_list positions."""
        out = []
        for f in frames:
            ci = self._wb_chan_to_ci.get(f.channel)
            if ci is None:
                continue
            f.channel = ci
            f.tap_header.frequency = int(self.channel_list[ci])
            out.append(f)
        return out

    def apply_cfo(self, cfo: float, channel: int = 0) -> None:
        """Accumulate a CFO correction into a channel's mixer
        (``channelizer_impl::apply_cfo``: ``d_cfo += cfo``, then retune),
        from the next chunk on. The mixer phase restarts at the retune, as
        the reference's ``set_center_freq`` does."""
        self.cfo[channel] += float(cfo)

    def flush(self) -> List[Frame]:
        if self._wb_stream is not None:
            frames = self._map_wb(self._wb_stream.flush())
            self._emit(frames)
            return frames
        frames: List[Frame] = []
        if self.route == "mixer_bank" and len(self._bank_pending):
            # drain the bank's sub-block remainder
            frames.extend(self._feed(self._channelize_bank(np.zeros(0, np.complex64),
                                                           final=True)))
        if self._streams is not None:
            for ci, s in enumerate(self._streams):
                for f in s.flush():
                    f.channel = ci
                    frames.append(f)
        else:
            from .receiver import LoRaReceiver  # buffered golden / parity

            rx = LoRaReceiver(
                samp_rate=self.config.samp_rate, center_freq=self.center_freq,
                channel_list=[self.center_freq], bandwidth=self.config.bandwidth,
                sf=self.config.sf, implicit=self.config.implicit,
                cr=self.config.cr, crc=self.config.crc,
                reduced_rate=self.config.reduced_rate,
                disable_channelization=True, engine=self.engine, device=self.device)
            for ci, buf in enumerate(self._buffered):
                for f in rx.receive(buf):
                    f.channel = ci
                    frames.append(f)
        self._emit(frames)
        return frames

    def _emit(self, frames: List[Frame]) -> None:
        for f in frames:
            for s in self.sinks:
                s.handle(f)

    def close(self) -> None:
        if self._streams is not None:
            for s in self._streams:
                s.close()
        if self._wb_stream is not None:
            self._wb_stream.close()


class StreamingGateway:
    """Gateway block: every channel x every spreading factor, streaming with
    bounded memory on ``device`` (``None``: the card).

    A :class:`~lora_tpu_torch.wideband.MultiSFWidebandReceiver` (the PFB
    grid, ``channels``) or a :class:`~lora_tpu_torch.plans.PlanGateway`
    (``plan``: EU868/US915/AU915 on the LoRaWAN raster) inside
    :class:`~lora_tpu_torch.stream.WidebandStreamingReceiver`. The
    reference needs one flowgraph per (channel, SF) pair."""

    def __init__(self, samp_rate: float = 2e6, center_freq: float = 868.0e6,
                 channels: int = 8, plan: str = "",
                 sfs: Sequence[int] = (7, 8, 9, 10, 11, 12), cr: int = 4,
                 crc: bool = True, implicit: bool = False,
                 bandwidth: float = 125e3, sync_word: Optional[int] = None,
                 pool: int = 16, block_symbols: int = 512,
                 bf16: bool = False, header_checksum: bool = False, device=None):
        from .stream import WidebandStreamingReceiver

        kw = {"plane_dtype": torch.bfloat16} if bf16 else {}
        if plan:
            from .plans import PlanGateway

            gw = PlanGateway(
                plan, float(center_freq), float(samp_rate),
                sfs=tuple(int(s) for s in sfs), bandwidth=float(bandwidth),
                cr=int(cr), crc=bool(crc), implicit=bool(implicit),
                sync_word=0x34 if sync_word is None else int(sync_word),
                pool=int(pool), header_checksum=bool(header_checksum),
                demod_method="fft", device=device, **kw)
        else:
            from .wideband import MultiSFWidebandReceiver

            M = int(channels)
            cfg = LoRaConfig(
                sf=int(sfs[0]), cr=int(cr), samp_rate=float(samp_rate) / M,
                bandwidth=float(bandwidth), crc=bool(crc), implicit=bool(implicit),
                sync_word=0x00 if sync_word is None else int(sync_word))
            gw = MultiSFWidebandReceiver(
                cfg, M, sfs=tuple(int(s) for s in sfs), pool=int(pool),
                demod_method="fft", header_checksum=bool(header_checksum),
                device=device, **kw)
        self.gateway = gw
        self._sr = WidebandStreamingReceiver(gw, block_symbols=int(block_symbols))

    # the runner assigns receiver.sinks: the streamer delivers to them
    @property
    def sinks(self) -> List[Any]:
        return self._sr.sinks

    @sinks.setter
    def sinks(self, v) -> None:
        self._sr.sinks = list(v)

    def push(self, x: np.ndarray) -> List[Frame]:
        return self._sr.push(x)

    def flush(self) -> List[Frame]:
        return self._sr.flush()

    def close(self) -> None:
        self._sr.close()


# --------------------------------------------------------------------------
# registry entries (descriptors equal to the JAX package's)
# --------------------------------------------------------------------------

_register(BlockSpec(
    "file_source", "File Source", "source",
    [Param("file", "file_open"), Param("repeat", "bool", False),
     Param("chunk_samples", "int", 1 << 18)],
    FileSource, doc="cf32/SigMF IQ file source (blocks_file_source)."))
_register(BlockSpec(
    "stdin_source", "Stdin IQ Source", "source",
    [Param("chunk_samples", "int", 1 << 17)],
    StdinSource, doc="cf32 IQ on stdin (pipe an SDR tool in)."))
_register(BlockSpec(
    "udp_iq_source", "UDP IQ Source", "source",
    [Param("addr", "string", "0.0.0.0"), Param("port", "int", 40900),
     Param("timeout", "float", 5.0), Param("max_samples", "int", None)],
    UdpIqSource, doc="cf32 IQ over UDP datagrams (live-SDR ingest; "
                     "replaces uhd_usrp_source)."))
_register(BlockSpec(
    "throttle", "Throttle", "stream",
    [Param("samp_rate", "float", 1e6)],
    Throttle, doc="Pace the stream to samp_rate (blocks_throttle)."))
_register(BlockSpec(
    "lora_receiver", "LoRa Receiver", "receiver",
    [Param("samp_rate", "float", 1e6), Param("center_freq", "float", 868e6),
     Param("channel_list", "float_vector", [868.1e6]),
     Param("bandwidth", "int", 125000), Param("sf", "int", 7),
     Param("implicit", "bool", False), Param("cr", "enum[4,3,2,1]", 4),
     Param("crc", "bool", True), Param("reduced_rate", "bool", False),
     Param("conj", "bool", False), Param("decimation", "int", 1),
     Param("disable_channelization", "bool", False),
     Param("disable_drift_correction", "bool", False),
     Param("engine", "enum[dense,parity,golden]", "dense"),
     Param("block_symbols", "int", 512),
     Param("max_candidates", "int", 8), Param("max_symbols", "int", 48)],
    StreamingLoRaReceiver,
    doc="Complete LoRa PHY receiver (grc/lora_receiver.block.yml), "
        "streaming all listed channels (the reference decodes only "
        "channel_list[0])."))
_register(BlockSpec(
    "lora_gateway", "LoRa Gateway", "receiver",
    [Param("samp_rate", "float", 2e6), Param("center_freq", "float", 868.0e6),
     Param("channels", "int", 8), Param("plan", "string", ""),
     Param("sfs", "int_vector", [7, 8, 9, 10, 11, 12]),
     Param("cr", "enum[4,3,2,1]", 4), Param("crc", "bool", True),
     Param("implicit", "bool", False), Param("bandwidth", "float", 125000),
     Param("sync_word", "int", None), Param("pool", "int", 16),
     Param("block_symbols", "int", 512), Param("bf16", "bool", False),
     Param("header_checksum", "bool", False)],
    StreamingGateway,
    doc="Every channel x every SF in one streaming block: PFB grid "
        "(channels=M) or a LoRaWAN regional plan (plan=EU868/US915/"
        "AU915); the reference needs one flowgraph per (channel, SF)."))


def _mk_socket_sink(ip="127.0.0.1", port=40868, layer=0):
    from .io.udp import MessageSocketSink

    return MessageSocketSink(ip, int(port), int(layer))


def _mk_file_sink(file="frames.bin", layer=0):
    from .io.sinks import MessageFileSink

    return MessageFileSink(file, int(layer))


def _mk_mongodb_sink(uri="mongodb://localhost:27017/", db="lora",
                     collection="frames", tag=""):
    from .io.sinks import MessageMongoDBSink

    return MessageMongoDBSink(uri, db, collection, tag)


def _mk_socket_source(addr="0.0.0.0", port=40868):
    from .io.udp import MessageSocketSource

    return MessageSocketSource(addr, int(port))


_register(BlockSpec(
    "message_socket_sink", "Message Socket Sink", "sink",
    [Param("ip", "string", "127.0.0.1"), Param("port", "int", 40868),
     Param("layer", "enum[0:loratap,1:loraphy,2:loramac]", 0)],
    _mk_socket_sink,
    doc="UDP datagram frame sink (grc/lora_message_socket_sink.block.yml)."))
_register(BlockSpec(
    "message_file_sink", "Message File Sink", "sink",
    [Param("file", "file_save"), Param("layer", "int", 0)],
    _mk_file_sink,
    doc="Append frames to a binary file (grc/lora_message_file_sink.block.yml)."))
_register(BlockSpec(
    "message_mongodb_sink", "Message MongoDB Sink", "sink",
    [Param("uri", "string", "mongodb://localhost:27017/"),
     Param("db", "string", "lora"), Param("collection", "string", "frames"),
     Param("tag", "string", "")],
    _mk_mongodb_sink,
    doc="Store frames in MongoDB (grc/lora_message_mongodb_sink.block.yml)."))
_register(BlockSpec(
    "message_socket_source", "Message Socket Source", "msg_source",
    [Param("addr", "string", "0.0.0.0"), Param("port", "int", 40868)],
    _mk_socket_source,
    doc="Republish UDP datagrams as frames "
        "(grc/lora_message_socket_source.block.yml; "
        "lib/message_socket_source_impl.cc:49-97)."))
_register(BlockSpec(
    "frame_print_sink", "Frame Print Sink", "sink",
    [Param("layer", "int", 1)],
    FramePrintSink, doc="Hex-print frames to stdout (decoder printout)."))
_register(BlockSpec(
    "frame_collect_sink", "Frame Collect Sink", "sink", [],
    FrameCollectSink, doc="Collect frames in memory (for scripts/tests)."))


# --------------------------------------------------------------------------
# the flowgraph
# --------------------------------------------------------------------------

class Flowgraph:
    """A parsed, instantiated flowgraph ready to run; its receiver blocks
    run on ``device`` (``None``: the card)."""

    def __init__(self, spec: dict, device=None):
        self.spec = spec
        self.device = device
        variables: Dict[str, Any] = {}
        for k, v in (spec.get("variables") or {}).items():
            variables[k] = safe_eval(v, variables)
        self.variables = variables

        self.block_specs: Dict[str, dict] = {}
        self.blocks: Dict[str, Any] = {}
        self.kinds: Dict[str, str] = {}
        for b in spec.get("blocks", []):
            name, bid = b["name"], b["id"]
            if bid not in BLOCKS:
                raise ValueError(f"unknown block id {bid!r} (block {name!r}); "
                                 f"known: {sorted(BLOCKS)}")
            reg = BLOCKS[bid]
            ptypes = {p.id: p.dtype for p in reg.params}

            def _eval_param(k, v):
                try:
                    return safe_eval(v, variables)
                except NameError:
                    # a bare word in a string-typed parameter is the string
                    # itself (`plan: EU868`); a numeric typo still fails
                    if str(ptypes.get(k, "")).startswith(("string", "file")):
                        return str(v)
                    raise

            params = {k: _eval_param(k, v) for k, v in (b.get("parameters") or {}).items()}
            known = {p.id for p in reg.params}
            unknown = set(params) - known
            if unknown:
                raise ValueError(f"block {name!r} ({bid}): unknown parameters "
                                 f"{sorted(unknown)}; accepts {sorted(known)}")
            self.block_specs[name] = {"id": bid, "parameters": params}
            extra = {"device": self.device} if reg.kind == "receiver" else {}
            self.blocks[name] = reg.make(**params, **extra)
            self.kinds[name] = reg.kind

        self.connections = [tuple(c) for c in spec.get("connections", [])]
        self._wire()

    # -- graph resolution -----------------------------------------------------
    def _wire(self) -> None:
        sources = [n for n, k in self.kinds.items() if k == "source"]
        receivers = [n for n, k in self.kinds.items() if k == "receiver"]
        msg_sources = [n for n, k in self.kinds.items() if k == "msg_source"]
        if not receivers and len(msg_sources) == 1 and not sources:
            # message-only graph: msg_source -> sinks (the reference's
            # message_socket_source republish topology)
            self.msg_source_name = msg_sources[0]
            self.source_name = self.rx_name = None
            self.rx_names = []
            self.stream_chain = []
            self.collector = FrameCollectSink()
            self.msg_sinks = [self.collector]
            for (a, ap, b, bp) in self.connections:
                if a == self.msg_source_name:
                    if self.kinds.get(b) != "sink":
                        raise ValueError(f"{b!r} is not a sink")
                    self.msg_sinks.append(self.blocks[b])
            return
        self.msg_source_name = None
        if len(sources) != 1 or not receivers:
            raise ValueError(
                f"a flowgraph needs exactly one source and at least one "
                f"lora_receiver (or a single message_socket_source) "
                f"(got sources={sources}, receivers={receivers})")
        self.source_name = sources[0]
        self.rx_names = receivers
        self.rx_name = receivers[0]

        # stream path: source -> (stream blocks) -> receiver(s). One source
        # may fan out to several receivers (the multi-SF monitoring
        # topology); stream blocks form one shared chain, the fan-out at
        # its end
        succ: Dict[str, List[str]] = {}
        for (a, ap, b, bp) in self.connections:
            if str(ap) in ("0", 0) or self.kinds.get(a) == "source":
                succ.setdefault(a, []).append(b)
        node, self.stream_chain = self.source_name, []
        seen = set()
        reached: List[str] = []
        while True:
            nxts = succ.get(node, [])
            stream_nxts = [x for x in nxts if self.kinds.get(x) == "stream"]
            rx_nxts = [x for x in nxts if self.kinds.get(x) == "receiver"]
            bad = [x for x in nxts if self.kinds.get(x) not in ("stream", "receiver")]
            if bad:
                raise ValueError(f"block(s) {bad} cannot sit on the stream path")
            if stream_nxts and (len(stream_nxts) > 1 or rx_nxts):
                raise ValueError(
                    "stream fan-out is only supported after the last "
                    "stream block (split to receivers, not mid-chain)")
            if stream_nxts:
                node = stream_nxts[0]
                if node in seen:
                    raise ValueError("stream path contains a cycle")
                seen.add(node)
                self.stream_chain.append(self.blocks[node])
                continue
            reached = rx_nxts
            break
        missing = sorted(set(receivers) - set(reached))
        if not reached or missing:
            raise ValueError(
                f"no stream path from {self.source_name!r} to receiver(s) "
                f"{missing or receivers} in connections")

        # message path: each receiver's frames -> its connected sinks
        self.collector = FrameCollectSink()
        for rx_name in self.rx_names:
            rx = self.blocks[rx_name]
            rx.sinks = [self.collector]
            for (a, ap, b, bp) in self.connections:
                if a == rx_name:
                    if self.kinds.get(b) != "sink":
                        raise ValueError(f"{b!r} is not a sink")
                    rx.sinks.append(self.blocks[b])

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_dict(cls, spec: dict, device=None) -> "Flowgraph":
        return cls(spec, device=device)

    @classmethod
    def from_yaml(cls, path: str, device=None) -> "Flowgraph":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f), device=device)

    # -- execution ------------------------------------------------------------
    def run(self, max_frames: Optional[int] = None,
            max_seconds: Optional[float] = None) -> List[Frame]:
        """Pump the source through the receivers until its end (or a
        limit); returns every decoded frame. The counterpart of
        ``tb.start(); tb.wait()`` on the reference's flowgraph."""
        if self.msg_source_name is not None:
            return self._run_msg_graph(max_frames, max_seconds)
        src = self.blocks[self.source_name]
        rxs = [self.blocks[n] for n in self.rx_names]
        throttles = [b for b in self.stream_chain if isinstance(b, Throttle)]
        t0 = time.monotonic()
        try:
            for chunk in src.chunks():
                for th in throttles:
                    th.pace(len(chunk))
                for rx in rxs:
                    rx.push(chunk)
                if max_frames is not None and len(self.collector.frames) >= max_frames:
                    break
                if max_seconds is not None and time.monotonic() - t0 > max_seconds:
                    break
            for rx in rxs:
                rx.flush()
        finally:
            src.close()
            closed = set()
            for rx in rxs:
                rx.close()
                for s in rx.sinks:
                    close = getattr(s, "close", None)
                    if close and id(s) not in closed:
                        closed.add(id(s))
                        close()
        return self.collector.frames

    def _run_msg_graph(self, max_frames: Optional[int],
                       max_seconds: Optional[float]) -> List[Frame]:
        """message_socket_source -> sinks: each received datagram
        republished as a Frame (the reference's message_socket_source
        topology); a datagram that is not a LoRaTap frame is skipped."""
        import queue as _queue

        src = self.blocks[self.msg_source_name]
        t0 = time.monotonic()
        try:
            while True:
                if max_seconds is not None and time.monotonic() - t0 > max_seconds:
                    break
                if max_frames is not None and len(self.collector.frames) >= max_frames:
                    break
                try:
                    data = src.get(timeout=0.2)
                except _queue.Empty:
                    continue
                try:
                    f = Frame.from_bytes(data)
                except ValueError:
                    continue
                for s in self.msg_sinks:
                    s.handle(f)
        finally:
            src.close()
            for s in self.msg_sinks:
                close = getattr(s, "close", None)
                if close:
                    close()
        return self.collector.frames


def run_flowgraph(path: str, max_frames: Optional[int] = None,
                  max_seconds: Optional[float] = None, device=None) -> List[Frame]:
    """Run the YAML flowgraph at ``path`` on ``device`` (``None``: the card)."""
    return Flowgraph.from_yaml(path, device=device).run(max_frames=max_frames,
                                                        max_seconds=max_seconds)
