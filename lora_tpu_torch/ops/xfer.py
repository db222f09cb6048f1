"""Packed IQ planes.

IQ travels as real/imag planes ``[..., 2, L]`` in float32 or bfloat16,
the layout the detection kernel reads. bf16 halves every read of the
block; its ~2.6 significant digits put quantization ~40 dB under the
signal, far below the receiver's 10 dB operating floor.

:func:`pack_iq` moves one host block to the card with a plain copy (set-up
and one-shot calls). The streamers move block after block through a
:class:`PinnedStager`, whose page-locked slots let each copy run
asynchronously while the card decodes earlier blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def pack_iq(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """Complex ``[..., L]`` (host array, or a tensor on any device) ->
    ``dtype`` planes ``[..., 2, L]`` on ``device`` (``None``: the card).
    The complex64 block is moved once and split on the device; float32 ->
    bfloat16 rounds to nearest even, as numpy's bfloat16 cast does."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack_iq packs float32 or bfloat16 planes, not {dtype}")
    if isinstance(x, torch.Tensor):
        if not x.is_complex():
            raise TypeError("pack_iq expects a complex array")
        t = x.to(resolve_device(device), torch.complex64)
    else:
        x = np.asarray(x)
        if not np.iscomplexobj(x):
            raise TypeError("pack_iq expects a complex array")
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.complex64))
        t = t.to(resolve_device(device))
    return torch.stack([t.real, t.imag], dim=-2).to(dtype).contiguous()


class PinnedStager:
    """Host-to-card staging of fixed-length complex64 blocks.

    Owns ``slots`` host buffers of ``block_len`` complex64 samples,
    page-locked when ``device`` is a CUDA device. :meth:`stage` fills the
    next slot on the host, issues one ``non_blocking`` copy of it to the
    card on the current stream, records a CUDA event after the copy, and
    splits the block into float32 planes ``[2, block_len]`` on the card.
    A slot is filled again only once its event has completed, so a copy
    still in flight never reads a slot being refilled; with ``slots`` one
    more than the blocks a caller keeps queued on the card, the event has
    always completed by then and staging never waits. On the CPU the
    slots are plain buffers and the copy is the split itself.
    """

    def __init__(self, block_len: int, slots: int, device=None):
        self.device = resolve_device(device)
        self.block_len = int(block_len)
        pin = self.device.type == "cuda"
        self._slots = [torch.empty(self.block_len, dtype=torch.complex64, pin_memory=pin)
                       for _ in range(max(1, int(slots)))]
        self._views = [s.numpy() for s in self._slots]
        self._copied = [None] * len(self._slots)
        self._next = 0

    def stage(self, fill) -> torch.Tensor:
        """``fill(buf)`` writes the block into ``buf`` (a numpy complex64
        view of the slot, ``block_len`` long); returns its float32 planes
        ``[2, block_len]`` on the device, enqueued behind the copy."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        copied = self._copied[i]
        if copied is not None and not copied.query():
            copied.synchronize()
        fill(self._views[i])
        x = self._slots[i].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record()
        return torch.stack([x.real, x.imag])


def unpack_iq(xf: torch.Tensor) -> torch.Tensor:
    """Planes ``[..., 2, L]`` -> complex64 ``[..., L]``."""
    xf = xf.to(torch.float32)
    return torch.complex(xf[..., 0, :], xf[..., 1, :])
