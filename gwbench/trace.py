"""Reduction of a ``torch.profiler`` trace to what the metrics read.

The trace is the profiler's Chrome-trace export. Device work is every
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` event. A device event
belongs to a span (a ``record_function`` the benchmark put around a call
into the program) when the host launch that the profiler correlates with
it (``args.correlation``) ran inside that span, on the span's thread: a
layer's time is found by who launched the work, never by a kernel's name.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Intervals:
    """Sorted host intervals ``[ts, ts + dur)`` of one thread, nested."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ev]

    def enclosing(self, ts: float) -> List[dict]:
        """Every interval that holds ``ts``, outermost first."""
        i = bisect.bisect_right(self.starts, ts)
        return [e for e in self.ev[max(0, i - 512):i] if e["ts"] + e["dur"] >= ts]


def reduce(path: str, window_span: str) -> Dict:
    """Read the exported trace at ``path``; the window is the host span
    named ``window_span``. Returns ``window_s``,
    ``busy_s`` (the union of device intervals in the window),
    ``span_device_s`` (``{span name: device seconds}``), ``span_calls``,
    ``device_ops`` (seconds by device op name, the ten longest) and
    ``idle_gaps`` (gap seconds by the host op that launched the work
    ending each gap, the ten longest) and ``launches`` (the host's
    kernel launches in the window)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, launch, spans, ops = [], {}, defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = e
        elif cat == "user_annotation":
            spans[e["tid"]].append(e)
        elif cat == "cpu_op":
            ops[e["tid"]].append(e)
    if not dev:
        return {}
    dev.sort(key=lambda e: e["ts"])
    win = [x for v in spans.values() for x in v if x["name"] == window_span]
    if not win:
        return {}
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    span_iv = {tid: _Intervals(v) for tid, v in spans.items()}
    op_iv = {tid: _Intervals(v) for tid, v in ops.items()}
    span_dev = defaultdict(float)
    by_name = defaultdict(float)
    busy, cur_s, cur_e = 0.0, None, None
    gaps = defaultdict(float)
    for e in dev:
        s, d = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if d <= s:
            continue
        by_name[e.get("name", "?")[:96]] += (d - s) * 1e-6
        host = launch.get(e.get("args", {}).get("correlation"))
        if host is not None:
            for sp in {x["name"] for x in span_iv.get(host["tid"], _Intervals([]))
                       .enclosing(host["ts"])}:
                span_dev[sp] += (d - s) * 1e-6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                who = "(no host op)"
                if host is not None:
                    inner = op_iv.get(host["tid"], _Intervals([])).enclosing(host["ts"])
                    who = inner[-1]["name"] if inner else host.get("name", who)
                gaps[who] += (s - cur_e) * 1e-6
            cur_s, cur_e = s, d
        else:
            cur_e = max(cur_e, d)
    if cur_e is not None:
        busy += cur_e - cur_s
    launches = sum(1 for e in launch.values()
                   if "LaunchKernel" in e.get("name", "") and lo <= e["ts"] <= hi)
    calls = defaultdict(int)
    for v in spans.values():
        for x in v:
            if lo <= x["ts"] <= hi:
                calls[x["name"]] += 1
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "span_device_s": dict(span_dev), "span_calls": dict(calls),
            "device_ops": top(by_name), "idle_gaps": top(gaps), "launches": launches}
