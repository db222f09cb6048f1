"""Spans and counters at the layer boundaries of the gateway path.

A span names a stage on the profiler's clock: while a ``torch.profiler``
records, :func:`span` enters ``torch.profiler.record_function``, so the
stage lands in the trace beside the kernel, copy and fill events it
launched and each device event can be put down to the stage whose host
launch it correlates with. With no profiler recording it returns one
shared no-op context and costs a flag check: profiling the process is the
switch. A span never synchronises, allocates on the device or changes
what a call returns.

The spans, nested as they run: ``lora.gateway`` (a plan gateway's call)
holds ``lora.channelize``, ``lora.cast``, ``lora.detect`` and one
``lora.sf`` an SF, which holds ``lora.pool`` and ``lora.phaseb``, which
holds ``lora.tail``; ``lora.frames`` is the host's frame building.

Counters (:func:`count`) are host-side and always on: they add numbers
the host already holds and never read the device. They are shared by the
process, as the profiler is; :func:`counters` returns a copy. The frame
builder counts, for each SF, the pool lanes it examines and the valid
ones (``frames.lanes.sf<N>``, ``frames.valid.sf<N>``).
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter

import torch

_OFF = contextlib.nullcontext()
_counts: Counter = Counter()


def span(name: str):
    """A context naming the stage ``name`` in the profiler's trace while
    one records, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> Counter:
    """A copy of every counter."""
    return Counter(_counts)
