"""Mesh sharding for the dense and wideband receivers.

Two orthogonal axes of scale:

- **Channel sharding** (:func:`channel_sharded_process`): the ``[C, 2,
  L]`` channel batch is split over the mesh and every shard decodes its
  channels; LoRa channels are independent, so no data moves between
  shards.
- **Time sharding** (:func:`time_sharded_process`): one long stream is
  split into per-shard blocks; each shard takes a halo of
  ``halo_samples`` from its right neighbour (overlap-save), decodes its
  block and halo, and claims only the packets that *start* inside its own
  block. The halo must cover one maximal packet, ``pkt_samples``.

The wideband forms apply the same to a capture:
:func:`wideband_time_sharded_process` runs the polyphase filterbank on
each shard's block and halo, and :func:`wideband_subband_sharded_process`
splits the band over the mesh with a coarse filterbank per time shard and
one band exchange.

A :class:`Mesh` (:func:`make_mesh`) holds its shards in one of two ways:

- **In this process** (no group): shard ``i`` lives on ``devices[i]``; a
  device may repeat (``["cpu"] * 8`` for tests, ``["cuda:0"] * 4`` to run
  a 4-shard program on one card). The halo and the band exchange are
  copies between the shards' devices (``.to(device, non_blocking=True)``;
  a slice, with no copy, between shards on one device). A function's
  result holds every shard's, gathered on the first shard's device.
- **One shard a rank** of a ``torch.distributed`` process group (NCCL for
  CUDA tensors, gloo for CPU ones), on the rank's device. The halo goes
  by ``batch_isend_irecv`` around the ring, the band exchange by
  ``all_to_all_single``; a transfer whose two ends are the same rank is a
  local copy (world size 1). The group's backend is used as it is. Each
  rank moves only its own slice of the input to its device, and a
  function's result is the rank's own shard.

A receiver is bound to one device. A shard on the receiver's device uses
the receiver; a shard on another device uses a replica built there, once
a function, from the arguments the receiver was constructed with
(``init_args``); tables installed after construction
(:func:`~lora_tpu_torch.convert.load_tables`) do not carry over to a
replica.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _canon(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device.
    Raises without a card for a CUDA device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A one-axis mesh of shards: ``devices`` (one a shard; with a group,
    this rank's device alone), the axis name, and the optional
    ``torch.distributed`` process group. The axis name only names the one
    axis, as JAX's mesh does: a sharded function's ``axis`` must be it
    (else ``KeyError``) and changes nothing else."""

    def __init__(self, devices: Sequence[torch.device], axis: str = "dev", group=None):
        self.devices = tuple(devices)
        self.axis = axis
        self.group = group

    @property
    def size(self) -> int:
        """Shards on the mesh: the device count, or the group's world size."""
        if self.group is None:
            return len(self.devices)
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def rank(self) -> Optional[int]:
        """This process's shard index in the group; ``None`` in-process."""
        if self.group is None:
            return None
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def local_shards(self) -> list:
        """``(shard index, device)`` of the shards this process runs."""
        if self.group is None:
            return list(enumerate(self.devices))
        return [(self.rank, self.devices[0])]

    def __repr__(self) -> str:
        where = "in-process" if self.group is None else f"rank {self.rank}"
        return (f"Mesh({self.axis}={self.size}, {where}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, axis: str = "dev",
              devices: Optional[Sequence] = None, group=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices``.

    Without ``group``: ``devices`` defaults to every visible CUDA device
    and raises without one (no quiet CPU mesh); a device may repeat. With
    ``group`` (a ``torch.distributed`` process group, e.g.
    ``dist.group.WORLD``): one shard a rank, on ``devices[0]`` (default:
    the current CUDA device); ``n_devices``, if given, must be the group's
    world size."""
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if n_devices is not None and n_devices != world:
            raise ValueError(f"n_devices={n_devices}, but the group has {world} ranks")
        devices = [None] if devices is None else list(devices)
        if len(devices) != 1:
            raise ValueError("a group mesh has one shard a rank: give the rank's own device")
        return Mesh([_canon(devices[0])], axis, group)
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_canon(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis)


# -- data movement -------------------------------------------------------
def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev`` (itself when it is there already); asynchronous
    where the copy lands on a card."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for a shard's work."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _as_tensor(xf) -> torch.Tensor:
    """Packed input as a tensor: a host array becomes a float32 CPU tensor
    (no copy when it is one already)."""
    if isinstance(xf, torch.Tensor):
        return xf
    return torch.from_numpy(np.ascontiguousarray(xf, np.float32))


def _from_right(head: torch.Tensor, group) -> torch.Tensor:
    """Send ``head`` to rank ``r - 1`` and return what rank ``r + 1`` sent
    (a ring: the last rank gets rank 0's)."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return head
    buf = torch.empty_like(head)
    ops = [dist.P2POp(dist.isend, head, dist.get_global_rank(group, (r - 1) % n), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (r + 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def _extended_blocks(x: torch.Tensor, mesh: Mesh, n: int, multiple: int, halo: int):
    """Split the stream ``x [2, L]`` into the mesh's ``n`` blocks (``L``
    divisible by ``n * multiple``, else ``ValueError``) and yield
    ``(shard, device, block length, block ‖ right halo)`` for each of this
    process's shards, the halo the first ``min(halo, block)`` samples of
    the next block (the last shard's from block 0)."""
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"expected one packed stream [2, L], got {tuple(x.shape)}")
    L = x.shape[-1]
    if L % (n * multiple):
        raise ValueError(f"stream length {L} is not divisible by {n * multiple} "
                         f"({n} shards x {multiple})")
    B = L // n
    h = min(halo, B)
    if mesh.group is None:
        blocks = [_to(x[:, d * B:(d + 1) * B], dev) for d, dev in enumerate(mesh.devices)]
        for d, dev in enumerate(mesh.devices):
            head = _to(blocks[(d + 1) % n][:, :h], dev)
            yield d, dev, B, torch.cat([blocks[d], head], dim=-1)
        return
    (r, dev), = mesh.local_shards()
    xb = _to(x[:, r * B:(r + 1) * B], dev)
    with _on(dev):
        head = _from_right(xb[:, :h].contiguous(), mesh.group)
    yield r, dev, B, torch.cat([xb, head], dim=-1)


def _gather(results: list, mesh: Mesh):
    """Shard results (each field with a leading shard or channel axis) ->
    one result, concatenated on that axis on the first shard's device;
    with a group, the rank's own."""
    if mesh.group is not None:
        return results[0]
    dev = mesh.devices[0]
    return type(results[0])(*(torch.cat([_to(f, dev) for f in fields])
                              for fields in zip(*results)))


def _placed(obj, mesh: Mesh) -> dict:
    """``{device: obj}`` for the devices of this process's shards: ``obj``
    itself on its own device, elsewhere a replica of it built there from
    ``obj.init_args``."""
    home = _canon(obj.device)
    return {dev: obj if dev == home else type(obj)(**obj.init_args, device=dev)
            for _, dev in mesh.local_shards()}


def _claimed(res, block: int):
    """``res`` with a leading axis of 1, ``valid`` cleared for packets
    starting at or past ``block``."""
    return type(res)(*(v[None] for v in res._replace(valid=res.valid & (res.start < block))))


# -- the sharded pipelines -------------------------------------------------
def channel_sharded_process(receiver, mesh: Mesh, axis: str = "dev"):
    """The dense pipeline with channels sharded over ``mesh``.

    Returns ``fn(xf)`` for packed IQ ``xf: [C, 2, L]`` (a host array or a
    tensor; see :func:`lora_tpu_torch.ops.xfer.pack_iq`) with ``C``
    divisible by the mesh size (else ``ValueError``). Each shard runs
    ``receiver.process_planes`` on its ``C / n`` channels; no data moves
    between shards. The result is the :class:`DenseResult` ``[C, P]`` of
    every channel (with a group: this rank's ``[C / n, P]``)."""
    n_dev = mesh.shape[axis]
    rxs = _placed(receiver, mesh)

    def fn(xf):
        x = _as_tensor(xf)
        if x.ndim != 3 or x.shape[1] != 2:
            raise ValueError(f"expected channel planes [C, 2, L], got {tuple(x.shape)}")
        C = x.shape[0]
        if C % n_dev:
            raise ValueError(f"{C} channels are not divisible by the mesh size {n_dev}")
        c = C // n_dev
        out = []
        for d, dev in mesh.local_shards():
            xb = _to(x[d * c:(d + 1) * c], dev)
            with _on(dev):
                out.append(rxs[dev].process_planes(xb))
        return _gather(out, mesh)

    return fn


def time_sharded_process(receiver, mesh: Mesh, axis: str = "dev",
                         halo_samples: Optional[int] = None):
    """An overlap-save time-sharded pipeline over ``mesh``.

    Returns ``fn(xf)`` for one packed stream ``xf: [2, L]`` with ``L``
    divisible by the mesh size (else ``ValueError``): each shard decodes
    its block plus a right halo of ``halo_samples`` (default
    ``receiver.pkt_samples``) and keeps only packets starting inside the
    block. Every result field has a leading shard axis ``[n, ...]``
    (``n_dropped`` ``[n]``; with a group ``[1, ...]``, this rank's);
    ``start`` values are block-relative."""
    n_dev = mesh.shape[axis]
    halo = int(receiver.pkt_samples if halo_samples is None else halo_samples)
    rxs = _placed(receiver, mesh)

    def fn(xf):
        out = []
        for _, dev, B, ext in _extended_blocks(_as_tensor(xf), mesh, n_dev, 1, halo):
            with _on(dev):
                out.append(_claimed(rxs[dev].process_planes(ext), B))
        return _gather(out, mesh)

    return fn


def wideband_time_sharded_process(wideband, mesh: Mesh, axis: str = "dev",
                                  halo_channel_samples: Optional[int] = None):
    """Time-shard a wideband capture: each shard channelizes and decodes
    its own block with a right halo.

    ``wideband``: a :class:`lora_tpu_torch.wideband.WidebandReceiver`.
    Returns ``fn(xf)`` for one packed wideband stream ``xf: [2, L]`` with
    ``L`` divisible by ``n * M`` (else ``ValueError``). Each shard runs the
    polyphase filterbank (all ``M`` channels) on its block and halo and
    decodes every channel (``wideband.rx.process_planes``); the halo is
    the packet region at the channel rate (``halo_channel_samples``,
    default ``wideband.rx.pkt_samples``) plus the filterbank's tail,
    ``(halo_channel_samples + K + 1) * M`` wideband samples. Every result
    field has a leading shard axis (``[n, M, P]``); ``start`` counts
    channel-rate samples from the shard's block."""
    n_dev = mesh.shape[axis]
    M = wideband.M
    if halo_channel_samples is None:
        halo_channel_samples = wideband.rx.pkt_samples
    halo = (int(halo_channel_samples) + wideband.pfb.K + 1) * M
    wbs = _placed(wideband, mesh)

    def fn(xf):
        out = []
        for _, dev, B, ext in _extended_blocks(_as_tensor(xf), mesh, n_dev, M, halo):
            wb = wbs[dev]
            with _on(dev):
                cp = wb.pfb.planes(ext, out_dtype=wb.plane_dtype)
                out.append(_claimed(wb.rx.process_planes(cp), B // M))
        return _gather(out, mesh)

    return fn


def _band_exchange(bands: list, mesh: Mesh) -> list:
    """Time-sharded bands -> band-sharded time: shard ``d`` gets band
    ``d``'s chunk from every time shard, concatenated in time order into
    ``[2, n * chunk]``. ``bands``: this process's ``[n, 2, chunk]`` coarse
    outputs, in shard order."""
    if mesh.group is None:
        return [torch.cat([_to(b[d], dev) for b in bands], dim=-1)
                for d, dev in mesh.local_shards()]
    import torch.distributed as dist

    send = bands[0].contiguous()
    n = send.shape[0]
    if n == 1:
        recv = send
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
    return [recv.permute(1, 0, 2).reshape(2, -1)]


def wideband_subband_sharded_process(wideband, mesh: Mesh, axis: str = "dev"):
    """Channel-count scale-out: two-stage channelization across the mesh.

    Stage 1 (time-parallel): each shard holds a time block of the
    full-band capture (rate ``n * wideband.wide_rate``), takes a right halo
    for the coarse FIR's tail and runs a critically sampled ``n``-band
    coarse filterbank, giving every subband's samples for its time block.
    One exchange then turns time-sharded bands into band-sharded time:
    shard ``d`` holds subband ``d`` for the whole capture (the coarse
    filterbank has no mixer state and a block is a whole number of coarse
    frames, so the chunks join seamlessly). Stage 2 (band-parallel): each
    shard fine-channelizes its subband with ``wideband``'s ``M``-channel
    filterbank and pool-decodes it (``wideband.pool``; without one,
    ``ValueError``).

    Returns ``fn(xf)`` for packed wideband ``xf [2, L]`` with ``L``
    divisible by ``n^2 * M`` (else ``ValueError``), giving a
    :class:`PooledResult` with a leading subband axis ``[n, pool]``
    (with a group, this rank's band, ``[1, pool]``); ``channel`` indexes
    fine channels within the subband: global fine channel ``band * M +
    channel`` in the nested FFT-bin convention
    (:func:`subband_channel_freq`)."""
    from ..channelizer import PolyphaseChannelizer, firdes_low_pass

    n_dev = mesh.shape[axis]
    if wideband.pool is None:
        raise ValueError("subband sharding uses the pooled decode path; "
                         "construct WidebandReceiver(pool=...)")
    # coarse prototype: pass the whole subband, stop by the neighbour's
    # center (transition spacing/5: K = ceil(ntaps/n) = 13)
    wide_rate = wideband.wide_rate * n_dev
    spacing = wide_rate / n_dev
    taps = firdes_low_pass(1.0, wide_rate, 0.42 * spacing, spacing / 5.0)
    wbs = _placed(wideband, mesh)
    coarse = {dev: PolyphaseChannelizer(n_dev, taps, device=dev) for dev in wbs}
    K = next(iter(coarse.values())).K
    halo = (K + 1) * n_dev

    def fn(xf):
        bands = []
        for _, dev, Ls, ext in _extended_blocks(_as_tensor(xf), mesh, n_dev,
                                                n_dev * wideband.M, halo):
            with _on(dev):
                bands.append(coarse[dev].planes(ext)[..., :Ls // n_dev])   # [n, 2, Ls/n]
        out = []
        for (_, dev), mine in zip(mesh.local_shards(), _band_exchange(bands, mesh)):
            wb = wbs[dev]
            with _on(dev):
                res = wb.rx.process_pooled_planes(
                    wb.pfb.planes(mine, out_dtype=wb.plane_dtype), wb.pool)
            out.append(type(res)(*(v[None] for v in res)))
        return _gather(out, mesh)

    return fn


def subband_channel_freq(wide_rate: float, n_bands: int, m_fine: int,
                         band: int, chan: int) -> float:
    """Center frequency (Hz rel. capture center) of fine channel
    ``chan`` in subband ``band`` of the two-stage channelizer."""
    f_band = band * wide_rate / n_bands
    if f_band >= wide_rate / 2:
        f_band -= wide_rate
    band_rate = wide_rate / n_bands
    f_chan = chan * band_rate / m_fine
    if f_chan >= band_rate / 2:
        f_chan -= band_rate
    return f_band + f_chan
