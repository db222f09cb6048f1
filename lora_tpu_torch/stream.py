"""Continuous streaming around the block receivers (the scheduler layer).

The port of :mod:`lora_tpu.stream`, with the same blocking, ownership and
dedup rules, so the same stream gives the same frames:

- **overlap-save blocking**: the unbounded IQ stream is cut into
  fixed-size blocks of ``hop + halo`` samples, ``halo >=`` one maximal
  packet region, so every packet is fully contained in at least one block.
- **ownership dedup**: a packet is emitted only by the block whose ``hop``
  region contains its start; packets straddling a seam are decoded by the
  next block, never twice, and a seam-clipped re-detection within 16
  symbols of an emission is suppressed and counted.
- **blocks in flight**: ``max_in_flight`` blocks stay queued on the card
  while the host fetches earlier results and ingests more samples. PyTorch
  runs this overlap only where it is built: each block goes from the ring
  straight into a page-locked staging slot (:class:`~lora_tpu_torch.ops.
  xfer.PinnedStager`), is copied to the card ``non_blocking`` and split
  into planes there, and the receiver's ``process_planes`` is enqueued
  behind the copy. Every field of the block's result is then copied back
  ``non_blocking`` into pinned host memory, and a CUDA event after those
  copies is the one host synchronisation a block costs, when it is
  drained.
- **bounded ring ingestion**: IQ flows through the port's own C++ SPSC ring
  (:class:`lora_tpu_torch.native.SampleRing`) with peek/advance
  overlap-save, or, when the caller chooses ``use_native_ring=False``, a
  numpy buffer. A failed native build raises: there is no quiet fallback.

The streamers run on the receiver's device: the card unless the receiver
was built with ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .io.frames import Frame, PhyHeader
from .ops.xfer import PinnedStager


def _dedup_and_emit(rx, seen, abs_start: int, payload: bytes, make_frame,
                    dedup_distance: int):
    """Seam dedup + CRC-preferring conflict resolution, shared by the
    streaming receivers.

    A packet whose rising edge is clipped by a block boundary re-detects
    in the next block at a slightly different start: a prior emission
    (``seen`` entry) within ``dedup_distance`` suppresses the re-detection
    (the first block, which saw the unclipped preamble, wins). If the
    suppressed decode's payload DIFFERS it is counted as a conflict; and
    if the later decode passes the MAC CRC while the blocker failed it,
    the clean frame is emitted as a CORRECTION: retracted from the pending
    list when the caller hasn't collected the corrupt one yet, otherwise
    delivered as a second emission flagged ``dedup_replacement`` +
    ``replaces``.

    ``rx`` provides ``_frames``/``sinks`` and the dedup counters; ``seen``
    is the mutable recent-emissions list for this (sf, channel); returns
    the emitted Frame or None.
    """
    blocker = next((s for s in seen if abs(abs_start - s[0]) < dedup_distance), None)
    if blocker is not None:
        if blocker[1] != payload:
            rx.n_dedup_conflicts += 1
            f_new = make_frame()
            f_old = blocker[2]
            if f_new.crc_ok and f_old is not None and f_old.crc_ok is False:
                rx.n_dedup_replaced += 1
                f_new.dedup_replacement = True
                f_new.replaces = f_old.sample_index
                if f_old in rx._frames:   # not yet collected by the caller
                    rx._frames.remove(f_old)
                seen[seen.index(blocker)] = (abs_start, payload, f_new)
                rx._frames.append(f_new)
                for s in rx.sinks:
                    s.handle(f_new)
                return f_new
        rx.n_dedup_suppressed += 1
        return None
    f = make_frame()
    seen.append((abs_start, payload, f))
    if len(seen) > 64:
        del seen[:32]
    rx._frames.append(f)
    for s in rx.sinks:
        s.handle(f)
    return f


class _IngestBuffer:
    """Ring or numpy IQ ingest shared by the streaming receivers.

    ``use_native``: the port's C++ SPSC ring of ``capacity_samples``
    complex64 (built at first use; raises if it cannot be); else an
    unbounded numpy buffer. ``write`` invokes ``on_full()`` when the ring
    is full (the caller consumes blocks to free space: backpressure)."""

    def __init__(self, capacity_samples: int, use_native: bool = True):
        self._ring = None
        if use_native:
            from .native import SampleRing

            self._ring = SampleRing(capacity_samples * 8)
        self._buf = np.zeros(0, np.complex64)

    @property
    def buffered(self) -> int:
        if self._ring is not None:
            return self._ring.readable // 8
        return len(self._buf)

    def write(self, x: np.ndarray, on_full) -> None:
        if self._ring is None:
            self._buf = np.concatenate([self._buf, x])
            return
        off = 0
        while off < len(x):
            wrote = self._ring.write(x[off:]) // 8
            off += wrote
            if wrote == 0:
                on_full()

    def take_into(self, dst: np.ndarray, n: int, consume: int) -> None:
        """Copy ``n`` samples from the head into ``dst`` (zeros past them),
        consuming ``consume``."""
        if self._ring is not None:
            got = self._ring.peek_into(dst, n * 8)
            if got != n * 8:
                raise RuntimeError(f"ring peek gave {got} of {n * 8} bytes")
            self._ring.advance(consume * 8)
        else:
            dst[:n] = self._buf[:n]
            self._buf = self._buf[consume:]
        dst[n:] = 0

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()
            self._ring = None


def _fetch(res):
    """Start copying every field of a block result (a result tuple, or
    ``{sf: result}``) to the host: ``non_blocking`` into pinned memory
    from the card, the tensors themselves on the CPU."""
    if isinstance(res, dict):
        return {k: _fetch(v) for k, v in res.items()}
    return type(res)(*(t.to("cpu", non_blocking=True) for t in res))


def _as_numpy(res):
    if isinstance(res, dict):
        return {k: _as_numpy(v) for k, v in res.items()}
    return type(res)(*(np.asarray(t) for t in res))


class _OverlapSave:
    """What both streamers share: ingest, blocking, staging, dispatch and
    drain. A subclass sets ``hop`` and ``halo``, then calls :meth:`_setup`
    with its receiver's device, and gives ``_process(planes)`` and
    ``_emit(host result, abs_offset, own)``."""

    def _setup(self, sinks, max_in_flight: int, use_native_ring: bool, device) -> None:
        self.block_len = self.hop + self.halo
        self.sinks = list(sinks)
        self.max_in_flight = max(1, max_in_flight)
        self._pending: List[tuple] = []   # (host result, copied event, abs offset, own)
        self._abs = 0                     # absolute sample index of the buffer head
        self._frames: List[Frame] = []
        # observability (no silent frame loss): every dedup suppression is
        # counted; a suppression whose payload DIFFERS from the frame that
        # blocked it is a conflict; a conflict resolved in favour of a
        # CRC-passing later decode is a replacement
        self.n_dedup_suppressed = 0
        self.n_dedup_conflicts = 0
        self.n_dedup_replaced = 0
        # capacity: a few blocks of packed complex64
        self._ingest = _IngestBuffer(8 * self.block_len, use_native=use_native_ring)
        # a slot for every block the dispatch can leave queued, plus one
        self._stager = PinnedStager(self.block_len, self.max_in_flight + 1, device)

    def push(self, samples) -> List[Frame]:
        """Append IQ samples; returns frames completed by this push."""
        x = np.ascontiguousarray(np.asarray(samples, dtype=np.complex64))
        # ring full -> consume blocks to free space (backpressure)
        self._ingest.write(x, on_full=lambda: self._pump(force=True))
        self._pump()
        return self._collect()

    def flush(self) -> List[Frame]:
        """End of stream: a halo of zeros, pump, then the partial tail
        block, zero-padded, and drain everything.

        The halo keeps a full decode region for a packet ending right at
        the stream tail in its owning block (zeros produce no candidates
        of their own). After the pump fewer than ``block_len`` samples
        remain, so one final block covers them."""
        self._ingest.write(np.zeros(self.halo, np.complex64),
                           on_full=lambda: self._pump(force=True))
        self._pump()
        n = self._ingest.buffered
        if n:
            self._dispatch(lambda dst: self._ingest.take_into(dst, n, n), self._abs, own=n)
            self._abs += n
        self._drain(0)
        return self._collect()

    def _pump(self, force: bool = False) -> None:
        while self._ingest.buffered >= self.block_len:
            self._dispatch(lambda dst: self._ingest.take_into(dst, self.block_len, self.hop),
                           self._abs, own=self.hop)
            self._abs += self.hop
            if not force:
                self._drain(self.max_in_flight - 1)
        if force:
            self._drain(0)

    def _dispatch(self, fill, abs_offset: int, own: int) -> None:
        self._enqueue(fill, abs_offset, own)
        self._drain(self.max_in_flight)

    def _enqueue(self, fill, abs_offset: int, own: int) -> None:
        """Stage one block (``fill`` writes it into a staging slot), enqueue
        its decode and the copy of its result to the host: no host
        synchronisation."""
        res = _fetch(self._process(self._stager.stage(fill)))
        fetched = None
        if self._stager.device.type == "cuda":
            fetched = torch.cuda.Event()
            fetched.record()
        self._pending.append((res, fetched, abs_offset, own))

    def _drain(self, keep: int) -> None:
        """Emit the oldest blocks' frames until ``keep`` remain queued: one
        host synchronisation (the block's event) each."""
        while len(self._pending) > keep:
            res, fetched, abs_offset, own = self._pending.pop(0)
            if fetched is not None:
                fetched.synchronize()
            self._emit(_as_numpy(res), abs_offset, own)

    def _collect(self) -> List[Frame]:
        out, self._frames = self._frames, []
        return out

    def close(self) -> None:
        self._ingest.close()


class StreamingReceiver(_OverlapSave):
    """Feed arbitrary-length IQ in, get deduplicated frames out.

    ``block_symbols``: owned (hop) region length per block, in symbols.
    Candidate capacity of ``receiver`` must cover the packets expected in
    one block. Each block reaches the receiver as float32 planes ``[1, 2,
    block_len]`` on its device (``process_planes``: no padding, as JAX's
    packed input)."""

    def __init__(self, receiver, block_symbols: int = 512, sinks: Sequence = (),
                 max_in_flight: int = 2, use_native_ring: bool = True):
        self.rx = receiver
        sps = receiver.sps
        self.hop = block_symbols * sps
        # halo: one full packet region + a sync symbol of slack
        self.halo = receiver.pkt_samples + 2 * sps
        if self.hop < self.halo:
            raise ValueError(
                f"block_symbols={block_symbols} gives hop {self.hop} < halo "
                f"{self.halo}; seam packets would outrun the next block's "
                f"owned region — use a larger block")
        self._emitted_starts: List[tuple] = []  # recent (abs start, payload, frame)
        # two decodable packets cannot start closer than preamble+header
        # (~20 symbols); a seam-clipped rising edge shifts the reported
        # start by at most a couple of windows: 16 symbols separates the
        # two cases with a wide margin either way
        self._dedup_distance = 16 * sps
        self._setup(sinks, max_in_flight, use_native_ring, receiver.device)

    def _process(self, planes):
        return self.rx.process_planes(planes[None])

    def _emit(self, r, abs_offset: int, own: int) -> None:
        valid, starts = r.valid[0], r.start[0]
        for k in np.nonzero(valid)[0]:
            if starts[k] >= own:  # owned by a later block
                continue
            abs_start = int(abs_offset + starts[k])
            payload = bytes(r.payload[0, k][: r.length[0, k]])

            def make_frame(k=k, abs_start=abs_start, payload=payload):
                return Frame(phy_header=PhyHeader.from_bytes(bytes(r.hdr[0, k])),
                             payload=payload, snr=float(r.snr[0, k]), channel=0,
                             sample_index=abs_start, cfo=float(r.cfo[0, k]))

            _dedup_and_emit(self, self._emitted_starts, abs_start, payload, make_frame,
                            self._dedup_distance)


class WidebandStreamingReceiver(_OverlapSave):
    """Continuous wideband streaming: channelizer + dense decode on the card.

    Takes a :class:`~lora_tpu_torch.wideband.WidebandReceiver`, a
    :class:`~lora_tpu_torch.wideband.MultiSFWidebandReceiver` (gateway
    mode: the block geometry is governed by the slowest SF, and every SF's
    pooled result is drained) or a :class:`~lora_tpu_torch.plans.
    PlanGateway` (the mixer-bank channelizer: the wideband-to-channel
    factor is its decimation, and its FIR warmup the whole-band filter
    length). Each block reaches ``process_planes`` as float32 planes ``[2,
    block_len]`` on the receiver's device.

    Blocking is overlap-save at the wideband rate: ``hop`` owned samples
    plus a halo covering one maximal packet region at channel rate and the
    channelizer's warmup, so every packet is fully contained in at least
    one block and emitted exactly once (ownership rule + seam dedup as in
    :class:`StreamingReceiver`). Each block's plan mixer restarts at phase
    0, a constant phase offset per block that no decode metric sees.
    """

    def __init__(self, wideband, block_symbols: int = 512, sinks: Sequence = (),
                 max_in_flight: int = 2, use_native_ring: bool = True):
        self.wb = wideband
        rxs = getattr(wideband, "rxs", None)
        if rxs is not None:
            sps = max(r.sps for r in rxs.values())
            pkt_samples = max(r.pkt_samples for r in rxs.values())
        else:
            sps = wideband.rx.sps
            pkt_samples = wideband.rx.pkt_samples
        pfb = getattr(wideband, "pfb", None)
        if pfb is not None:
            M = wideband.M
            warmup_chan = pfb.K + 1
        else:
            M = wideband.decim
            warmup_chan = -(-len(wideband.taps) // M) + 1
        self.M = M
        self.hop = block_symbols * sps * M
        halo_chan = pkt_samples + 2 * sps
        self.halo = (halo_chan + warmup_chan) * M
        if self.hop < self.halo:
            raise ValueError(
                f"block_symbols={block_symbols} gives hop {self.hop} < halo "
                f"{self.halo} wideband samples; use a larger block")
        # (sf, channel) -> recent (abs start, payload, frame); the dedup
        # window is 16 symbols of the *decoding* SF (a gateway's slowest-SF
        # window would swallow closely spaced SF7 traffic)
        self._emitted: dict = {}
        self._setup(sinks, max_in_flight, use_native_ring, wideband.device)

    def _process(self, planes):
        return self.wb.process_planes(planes)

    def _emit(self, r, abs_offset: int, own: int) -> None:
        rxs = getattr(self.wb, "rxs", None)
        if rxs is None:
            self._emit_result(r, self.wb.cfg, abs_offset, own)
        else:
            for sf in self.wb.sfs:
                self._emit_result(r[sf], rxs[sf].cfg, abs_offset, own)

    def _emit_result(self, r, cfg_sf, abs_offset: int, own: int) -> None:
        """Claim, dedup and emit one fetched block result's frames.
        ``cfg_sf`` is the decoding config (per SF in gateway mode: the SF
        stamp and the dedup key come from it)."""
        own_chan = own // self.M
        pooled = self.wb.pool is not None
        lanes = np.nonzero(r.valid)[0] if pooled else zip(*np.nonzero(r.valid))
        for lane in lanes:
            if pooled:
                sel = (int(lane),)
                chan = int(self.wb.active[int(r.channel[sel])])
            else:
                sel = tuple(int(v) for v in lane)
                chan = int(self.wb.active[sel[0]])
            start = int(r.start[sel])
            if start >= own_chan:
                continue  # owned by a later block
            abs_start = abs_offset // self.M + start
            payload = bytes(r.payload[sel][: r.length[sel]])

            def make_frame(sel=sel, chan=chan, abs_start=abs_start, payload=payload):
                f = Frame(phy_header=PhyHeader.from_bytes(bytes(r.hdr[sel])), payload=payload,
                          snr=float(r.snr[sel]), channel=chan, sample_index=abs_start,
                          cfo=float(r.cfo[sel]))
                f.tap_header.frequency = int(abs(self.wb.channel_freqs[chan]))
                f.tap_header.sf = cfg_sf.sf
                f.tap_header.sync_word = cfg_sf.sync_word
                return f

            seen = self._emitted.setdefault((cfg_sf.sf, chan), [])
            _dedup_and_emit(self, seen, abs_start, payload, make_frame,
                            16 * cfg_sf.samples_per_symbol)


def pump_file(sr, path: str, chunk_samples: Optional[int] = None,
              close: bool = True) -> List[Frame]:
    """Drive any streaming receiver (narrowband or wideband/gateway) from a
    cf32 capture file: chunked reads, push/flush, close.

    A trailing partial complex64 element (a recorder killed mid-write
    leaves ``size % 8 != 0``) is dropped, matching ``np.fromfile``'s
    whole-capture behaviour instead of crashing on the last chunk."""
    chunk = chunk_samples or sr.block_len
    frames: List[Frame] = []
    carry = b""
    with open(path, "rb") as f:
        while True:
            raw = carry + f.read(chunk * 8)
            if not raw:
                break
            n = len(raw) // 8 * 8
            carry = raw[n:]
            if not n:
                break
            frames += sr.push(np.frombuffer(raw[:n], dtype=np.complex64))
    frames += sr.flush()
    if close:
        sr.close()
    return frames


def stream_file(path: str, receiver, block_symbols: int = 512, sinks: Sequence = (),
                chunk_samples: Optional[int] = None) -> List[Frame]:
    """Decode a cf32 capture by streaming it through fixed-size blocks, the
    end-to-end analogue of ``file_source -> lora_receiver`` in the
    reference demo flowgraph (apps/lora_receive_file_nogui.py:30-40)."""
    sr = StreamingReceiver(receiver, block_symbols, sinks)
    return pump_file(sr, path, chunk_samples)
