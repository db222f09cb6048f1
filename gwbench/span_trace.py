"""The cell's blocks split by the program's spans (``lora_tpu_torch.
tracing``: ``lora.gateway``, ``lora.channelize``, ``lora.cast``,
``lora.detect``, ``lora.sf``, ``lora.pool``, ``lora.phaseb``,
``lora.tail``, ``lora.frames``), traced and on the host clock.

    python3 gwbench/span_trace.py --workload us915_64ch.sparse_aligned --seed 7

The command makes one traced run of the cell through ``run.run_cell``.
In its untraced window ``tracing.span`` is replaced by
:func:`host_clock`, which times each stage's host self time with no
profiler (``host_clock_ms``, a block: each stage's total and each of
its calls). Its traced blocks are reduced
twice, by ``trace.reduce`` for the metrics and by :func:`reduce_spans`,
which adds what ``trace.reduce`` lacks: launches, the host's time in
them, host self time (under the profiler) and idle gaps by span. It prints one JSON line: the run's
result line, those reductions a block, ``phaseb.launches`` and
``phaseb.idle_behind_ms``, the traced blocks' frame counters, and what
an empty span costs the host with no profiler and with one (``span_us``).

:func:`reduce_spans` repeats ``trace.reduce``'s reading of the events,
since ``gwbench/trace.py`` is the accepted benchmark's file; it goes
when ``trace.reduce`` gains those keys.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gwbench.trace import DEVICE_CATS, LAUNCH_CATS, _Intervals  # noqa: E402

PREFIX = "lora."
OUTSIDE = "(outside the program)"
NO_HOST = "(no host op)"
PHASE_B = ("lora.pool", "lora.phaseb")          # lora.tail runs inside lora.phaseb
BEHIND = ("lora.pool", "lora.phaseb", "lora.tail")


def _self_us(spans, lo: float, hi: float) -> Dict[str, float]:
    """Host self time by span name, in µs, of one thread's spans that
    start in ``[lo, hi]``: a span's duration minus its direct child
    spans' (of any name)."""
    out = defaultdict(float)
    stack = []                                   # [span, its self time so far]

    def close(rec):
        if lo <= rec[0]["ts"] <= hi:
            out[rec[0]["name"]] += rec[1]

    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
            close(stack.pop())
        if stack:
            stack[-1][1] -= e["dur"]
        stack.append([e, e["dur"]])
    while stack:
        close(stack.pop())
    return out


def reduce_spans(path: str, window_span: str) -> Dict:
    """Read the exported trace at ``path``; the window is the host span
    named ``window_span``. Returns, in the window:

    - ``span_launches``: kernel launches by every span name enclosing
      each (a launch counts once for each distinct enclosing name);
    - ``launches_by_span``: kernel launches by the innermost ``lora.*``
      span enclosing each, ``"(outside the program)"`` where none does
      (disjoint: they sum to ``trace.reduce``'s ``launches``);
    - ``launch_host_s``: host seconds inside those launch calls, by the
      same span (a launch that waits for room in the card's queue shows
      here);
    - ``span_self_host_s``: host self time by span name (its duration
      minus its direct child spans'; the window span's own is the host
      time outside every span in it);
    - ``gap_spans``: idle seconds by the innermost ``lora.*`` span
      enclosing the host launch of the work that ends each gap
      (``"(no host op)"`` where the profiler correlated no launch);
    - ``gap_span_ops``: the same seconds by that span and the host op
      that launched the work (the innermost ``cpu_op``, as
      ``trace.reduce`` names it), as ``"<span> <op>"``.

    ``{}`` where the trace has no device work or no window."""
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
    win = [x for v in spans.values() for x in v if x["name"] == window_span]
    if not dev or not win:
        return {}
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    span_iv = {tid: _Intervals(v) for tid, v in spans.items()}
    op_iv = {tid: _Intervals(v) for tid, v in ops.items()}
    none = _Intervals([])

    def enclosing(host):
        return span_iv.get(host["tid"], none).enclosing(host["ts"])

    def innermost(host):
        names = [x["name"] for x in enclosing(host) if x["name"].startswith(PREFIX)]
        return names[-1] if names else OUTSIDE

    span_launches, by_span, launch_s = defaultdict(int), defaultdict(int), defaultdict(float)
    for e in launch.values():
        if "LaunchKernel" in e.get("name", "") and lo <= e["ts"] <= hi:
            for name in {x["name"] for x in enclosing(e)}:
                span_launches[name] += 1
            by_span[innermost(e)] += 1
            launch_s[innermost(e)] += e["dur"] * 1e-6
    gaps, gap_ops = defaultdict(float), defaultdict(float)
    cur_e = None
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, d = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if d <= s:
            continue
        if cur_e is not None and s > cur_e:
            host = launch.get(e.get("args", {}).get("correlation"))
            who, op = NO_HOST, NO_HOST
            if host is not None:
                who = innermost(host)
                inner = op_iv.get(host["tid"], none).enclosing(host["ts"])
                op = inner[-1]["name"] if inner else host.get("name", NO_HOST)
            gaps[who] += (s - cur_e) * 1e-6
            gap_ops[f"{who} {op}"] += (s - cur_e) * 1e-6
        cur_e = d if cur_e is None else max(cur_e, d)
    self_s = defaultdict(float)
    for v in spans.values():
        for name, us in _self_us(v, lo, hi).items():
            self_s[name] += us * 1e-6
    return {"span_launches": dict(span_launches), "launches_by_span": dict(by_span),
            "launch_host_s": dict(launch_s), "span_self_host_s": dict(self_s),
            "gap_spans": dict(gaps), "gap_span_ops": dict(gap_ops)}


def by_block(red: Dict, blocks: int, window_span: str) -> Dict:
    """:func:`reduce_spans`'s reduction a block, largest first:
    ``launches_by_span``, ``launch_ms_by_span``, ``host_ms_by_span`` (the
    ``lora.*`` spans' self time, and the window's own as ``"(outside the
    program)"``), ``idle_ms_by_span``, the 16 largest of
    ``idle_ms_by_span_op``, and
    the readings ``phaseb.launches`` (launches in ``lora.pool`` and
    ``lora.phaseb``) and ``phaseb.idle_behind_ms`` (idle behind
    ``lora.pool``, ``lora.phaseb`` and ``lora.tail``)."""
    def per(d, scale=1.0):
        return {k: v * scale / blocks for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    host = {k: v for k, v in red["span_self_host_s"].items() if k.startswith(PREFIX)}
    host[OUTSIDE] = red["span_self_host_s"].get(window_span, 0.0)
    sl, gaps = red["span_launches"], red["gap_spans"]
    return {"launches_by_span": per(red["launches_by_span"]),
            "launch_ms_by_span": per(red["launch_host_s"], 1e3),
            "host_ms_by_span": per(host, 1e3),
            "idle_ms_by_span": per(gaps, 1e3),
            "idle_ms_by_span_op": dict(list(per(red["gap_span_ops"], 1e3).items())[:16]),
            "phaseb.launches": sum(sl.get(k, 0) for k in PHASE_B) / blocks,
            "phaseb.idle_behind_ms": 1e3 * sum(gaps.get(k, 0.0) for k in BEHIND) / blocks}


def host_clock(clock=time.perf_counter):
    """A stand-in for ``tracing.span`` that times each stage on the host
    clock, with no profiler. Returns ``(span, blocks)``: at the end of
    each ``lora.gateway`` call ``blocks`` gains a dict of host self time
    by span name in ms (a span's time less its child spans'), a list of
    one entry a call in the order they ran, holding every span closed
    since the last one; ``lora.frames``, which runs at drain outside the
    gateway's call, so goes to the next call's."""
    depth, cur, blocks = [], defaultdict(list), []

    @contextlib.contextmanager
    def span(name):
        depth.append(0.0)                  # the children's time
        t0 = clock()
        try:
            yield
        finally:
            dt = clock() - t0
            cur[name].append((dt - depth.pop()) * 1e3)
            if depth:
                depth[-1] += dt
            if name == "lora.gateway":
                blocks.append(dict(cur))
                cur.clear()
    return span, blocks


def mean_ms(blocks) -> Dict[str, Dict]:
    """:func:`host_clock`'s blocks, the mean over them: ``total`` by span
    name, largest first, with their sum as ``"lora.*"``; ``calls``, by
    span name, the mean of each call in the order they ran (the SFs in
    the gateway's order), where every block made as many calls."""
    tot, calls = defaultdict(float), {}
    for k in {k for b in blocks for k in b}:
        runs = [b.get(k, []) for b in blocks]
        tot[k] = sum(map(sum, runs)) / len(blocks)
        if len({len(r) for r in runs}) == 1:
            calls[k] = [sum(c) / len(blocks) for c in zip(*runs)]
    total = dict(sorted(tot.items(), key=lambda kv: -kv[1]))
    total["lora.*"] = sum(tot.values())
    return {"total": total, "calls": calls}


def span_us(n: int) -> Dict:
    """Host µs of one ``with tracing.span(...)`` and nothing inside, over
    ``n`` spans with no profiler (``off``) and ``n // 10`` with one
    recording the CPU and the card (``on``)."""
    import torch

    from lora_tpu_torch import tracing

    def each(k):
        t0 = time.perf_counter()
        for _ in range(k):
            with tracing.span("lora.cost"):
                pass
        return (time.perf_counter() - t0) * 1e6 / k

    off = each(n)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = each(n // 10)
    return {"off": off, "on": on}


def study(spec: dict, seed: int, seconds: float, device: str = "cuda") -> dict:
    """The command's result object (see the module's docstring)."""
    from gwbench import run, trace
    from lora_tpu_torch import tracing

    span, blocks = host_clock()
    got = {}
    saved = tracing.span, run._traced_segment, trace.reduce

    def segment(gw, loop, trace_dir):
        tracing.span = saved[0]
        n, before = len(blocks), tracing.counters()
        got["window_blocks"] = blocks[int(spec["cfg"]["in_flight"]) + 1:n]   # past the warm
        try:
            return saved[1](gw, loop, trace_dir)
        finally:
            c = tracing.counters()
            c.subtract(before)
            got["counters"] = {k: v for k, v in sorted(c.items()) if v}

    def reduce(path, window_span):
        got["spans"] = reduce_spans(path, window_span)
        got["window_span"] = window_span
        return saved[2](path, window_span)

    tracing.span, run._traced_segment, trace.reduce = span, segment, reduce
    try:
        res = run.run_cell(spec, seed, seconds, True, device)
    finally:
        tracing.span, run._traced_segment, trace.reduce = saved
    out = {"result": res, "counters": got.get("counters"),
           "host_clock_blocks": len(got.get("window_blocks", [])),
           "host_clock_ms": mean_ms(got["window_blocks"]) if got.get("window_blocks") else None}
    if got.get("spans"):
        out.update(by_block(got["spans"], run.TRACE_BLOCKS, got["window_span"]))
    if device == "cuda":
        out["span_us"] = span_us(100_000)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    from gwbench import run

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_trace: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(study(run.load_mix(args.workload), args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
