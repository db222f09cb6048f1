"""The benchmark's trace reductions on the program's spans, on a synthetic
Chrome trace (CPU, no profiler): ``gwbench/trace.reduce`` reads what it
read before the program had spans (its keys pinned as constants, worked
by hand below) and gains their device time; ``gwbench/span_trace``'s
launches, host self time and idle gaps by span, and its host-clock
stand-in for the spans; the two metric readers that read the program's
span and counters.

The trace, in µs (host thread 1, device 7): the window [0, 1000); the
harness's ``gw.process_planes`` [100, 520) around ``lora.gateway`` [105,
515), which holds ``lora.channelize`` [110, 150), ``lora.cast`` [150,
160) and ``lora.sf`` [200, 500), which holds ``lora.pool`` [210, 250) and
``lora.phaseb`` [260, 490), which holds ``lora.tail`` [400, 480); then
``lora.frames`` [800, 850). Device work: K5-like [115, 215) launched in
channelize, a copy [215, 225) in cast, kernels [240, 250) in pool, [300,
340) in phaseb, [420, 440) in tail, the harness's result copy [610, 620)
and a kernel [905, 915) outside the program, a fill [700, 705) that no
launch correlates with. Gaps: 15 before pool's kernel, 50 before
phaseb's, 80 before tail's, 170 before the result copy, 80 before the
fill, 200 before the last kernel.
"""

import json
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gwbench import run, span_trace, trace  # noqa: E402
from lora_tpu_torch import tracing  # noqa: E402


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _launch(name, ts, corr, op, op_ts):
    return [_ev("cpu_op", op, op_ts, 10), _ev("cuda_runtime", name, ts, 2, correlation=corr)]


SPANS = [("gwbench.window", 0, 1000), ("gw.process_planes", 100, 420),
         ("lora.gateway", 105, 410), ("lora.channelize", 110, 40), ("lora.cast", 150, 10),
         ("lora.sf", 200, 300), ("lora.pool", 210, 40), ("lora.phaseb", 260, 230),
         ("lora.tail", 400, 80), ("lora.frames", 800, 50)]


def _events():
    ev = [_ev("user_annotation", n, ts, dur) for n, ts, dur in SPANS]
    ev += _launch("cudaLaunchKernel", 112, 1, "aten::chan", 111)
    ev += _launch("cudaMemcpyAsync", 152, 2, "aten::copy_", 151)
    ev += _launch("cudaLaunchKernel", 221, 3, "aten::index", 220)
    ev += _launch("cudaLaunchKernel", 301, 4, "aten::mm", 300)
    ev += _launch("cudaLaunchKernel", 411, 5, "aten::bitwise_and", 410)
    ev += _launch("cudaMemcpyAsync", 601, 6, "aten::copy_", 600)
    ev += _launch("cudaLaunchKernel", 900, 7, "aten::add", 899)
    ev += [_ev("kernel", "k_chan", 115, 100, tid=7, correlation=1),
           _ev("gpu_memcpy", "Memcpy DtoD", 215, 10, tid=7, correlation=2),
           _ev("kernel", "k_pool", 240, 10, tid=7, correlation=3),
           _ev("kernel", "k_mm", 300, 40, tid=7, correlation=4),
           _ev("kernel", "k_tail", 420, 20, tid=7, correlation=5),
           _ev("gpu_memcpy", "Memcpy DtoH", 610, 10, tid=7, correlation=6),
           _ev("gpu_memset", "Memset", 700, 5, tid=7, correlation=99),
           _ev("kernel", "k_add", 905, 10, tid=7, correlation=7)]
    return ev


@pytest.fixture
def trace_path(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    return str(p)


def test_reduce_reads_as_before_and_gains_the_program_spans(trace_path):
    out = trace.reduce(trace_path, "gwbench.window")
    assert set(out) == {"window_s", "busy_s", "span_device_s", "span_calls", "device_ops",
                        "idle_gaps", "launches"}
    assert out["window_s"] == pytest.approx(1000e-6)
    # [115, 225), [240, 250), [300, 340), [420, 440), [610, 620), [700, 705), [905, 915)
    assert out["busy_s"] == pytest.approx(205e-6)
    want_dev = {"gwbench.window": 200e-6, "gw.process_planes": 180e-6, "lora.gateway": 180e-6,
                "lora.channelize": 100e-6, "lora.cast": 10e-6, "lora.sf": 70e-6,
                "lora.pool": 10e-6, "lora.phaseb": 60e-6, "lora.tail": 20e-6}
    assert out["span_device_s"] == pytest.approx(want_dev)
    assert out["span_calls"] == {n: 1 for n, _, _ in SPANS}
    assert [k for k, _ in out["idle_gaps"]] == ["aten::add", "aten::copy_", "aten::bitwise_and",
                                                "(no host op)", "aten::mm", "aten::index"]
    assert [v for _, v in out["idle_gaps"]] == pytest.approx([200e-6, 170e-6, 80e-6, 80e-6,
                                                              50e-6, 15e-6])
    assert out["device_ops"][0] == ["k_chan", pytest.approx(100e-6)]
    assert len(out["device_ops"]) == 8
    assert out["launches"] == 5


def test_reduce_spans(trace_path):
    red = span_trace.reduce_spans(trace_path, "gwbench.window")
    outside = span_trace.OUTSIDE
    assert set(red) == {"span_launches", "launches_by_span", "launch_host_s",
                        "span_self_host_s", "gap_spans", "gap_span_ops"}
    assert red["span_launches"] == {"gwbench.window": 5, "gw.process_planes": 4,
                                    "lora.gateway": 4, "lora.channelize": 1, "lora.sf": 3,
                                    "lora.pool": 1, "lora.phaseb": 2, "lora.tail": 1}
    assert red["launches_by_span"] == {"lora.channelize": 1, "lora.pool": 1,
                                       "lora.phaseb": 1, "lora.tail": 1, outside: 1}
    assert red["launch_host_s"] == pytest.approx({k: 2e-6 for k in red["launches_by_span"]})
    assert sum(red["launches_by_span"].values()) == \
        trace.reduce(trace_path, "gwbench.window")["launches"] == 5
    assert red["gap_spans"] == pytest.approx({"lora.pool": 15e-6, "lora.phaseb": 50e-6,
                                              "lora.tail": 80e-6, outside: 370e-6,
                                              "(no host op)": 80e-6})
    assert red["gap_span_ops"] == pytest.approx({
        "lora.pool aten::index": 15e-6, "lora.phaseb aten::mm": 50e-6,
        "lora.tail aten::bitwise_and": 80e-6, f"{outside} aten::copy_": 170e-6,
        f"{outside} aten::add": 200e-6, "(no host op) (no host op)": 80e-6})
    # a span's duration less its direct children's, whatever their names
    assert red["span_self_host_s"] == pytest.approx({
        "gwbench.window": 530e-6, "gw.process_planes": 10e-6, "lora.gateway": 60e-6,
        "lora.channelize": 40e-6, "lora.cast": 10e-6, "lora.sf": 30e-6, "lora.pool": 40e-6,
        "lora.phaseb": 150e-6, "lora.tail": 80e-6, "lora.frames": 50e-6})
    assert sum(red["span_self_host_s"].values()) == pytest.approx(1000e-6)


def test_by_block(trace_path):
    red = span_trace.reduce_spans(trace_path, "gwbench.window")
    b = span_trace.by_block(red, 2, "gwbench.window")
    assert b["phaseb.launches"] == 1.5                   # pool 1 + phaseb 2 (its tail's too)
    assert b["phaseb.idle_behind_ms"] == pytest.approx((15 + 50 + 80) * 1e-3 / 2)
    assert b["idle_ms_by_span"][span_trace.OUTSIDE] == pytest.approx(0.185)
    assert list(b["idle_ms_by_span"])[0] == span_trace.OUTSIDE      # largest first
    assert list(b["idle_ms_by_span_op"].items())[0] == (f"{span_trace.OUTSIDE} aten::add",
                                                         pytest.approx(0.1))
    host = b["host_ms_by_span"]
    assert host[span_trace.OUTSIDE] == pytest.approx(0.265)
    assert "gw.process_planes" not in host and host["lora.phaseb"] == pytest.approx(0.075)
    assert sum(b["launches_by_span"].values()) == 2.5


def test_reduce_spans_reads_nothing_from_nothing(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [e for e in _events() if e["cat"] != "kernel"
                                             and not e["cat"].startswith("gpu_")]}))
    assert span_trace.reduce_spans(str(p), "gwbench.window") == {}
    p.write_text(json.dumps({"traceEvents": _events()}))
    assert span_trace.reduce_spans(str(p), "no.such.window") == {}


def test_every_enclosing_span_is_reached_over_a_traced_segment(tmp_path):
    """A traced segment's twelve blocks, each with the harness's seven
    spans and the program's 24 (four SFs): the window and each block's
    spans enclose each of its launches (the reduction looks back over 512
    intervals)."""
    blocks, ev, corr = 12, [_ev("user_annotation", "gwbench.window", 0, 12 * 10_000)], 0
    for b in range(blocks):
        t = b * 10_000
        ev += [_ev("user_annotation", "gw.process_planes", t + 10, 5000),
               _ev("user_annotation", "lora.gateway", t + 11, 4998),
               _ev("user_annotation", "gw.channel_planes", t + 20, 100),
               _ev("user_annotation", "lora.channelize", t + 21, 98),
               _ev("user_annotation", "lora.cast", t + 130, 10),
               _ev("user_annotation", "gw.detect", t + 150, 100),
               _ev("user_annotation", "lora.detect", t + 151, 98)]
        for i, sf in enumerate((7, 8, 9, 10)):
            s = t + 300 + 1000 * i
            ev += [_ev("user_annotation", f"gw.phaseb.sf{sf}", s, 900),
                   _ev("user_annotation", "lora.sf", s + 1, 898),
                   _ev("user_annotation", "lora.pool", s + 2, 100),
                   _ev("user_annotation", "lora.phaseb", s + 200, 690),
                   _ev("user_annotation", "lora.tail", s + 700, 180)]
            corr += 1
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", s + 870, 2, correlation=corr),
                   _ev("kernel", "k_tail", s + 875, 5, tid=7, correlation=corr)]
        ev += [_ev("user_annotation", "lora.frames", t + 6000 + 100 * i, 50) for i in range(4)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    red = span_trace.reduce_spans(str(p), "gwbench.window")
    n = blocks * 4
    assert trace.reduce(str(p), "gwbench.window")["launches"] == n
    assert red["span_launches"] == {k: n for k in ("gwbench.window", "gw.process_planes",
                                                   "lora.gateway", "lora.sf", "lora.phaseb",
                                                   "lora.tail")} | {
        f"gw.phaseb.sf{sf}": blocks for sf in (7, 8, 9, 10)}
    assert red["launches_by_span"] == {"lora.tail": n}
    assert trace.reduce(str(p), "gwbench.window")["span_device_s"]["gwbench.window"] == \
        pytest.approx(n * 5e-6)


def test_host_clock_times_each_stage_less_its_children():
    """The stand-in for ``tracing.span`` on a clock that ticks 1 s a
    read: each span's self time, a block closed at each ``lora.gateway``,
    the frames built between two calls going to the second."""
    ticks = iter(range(100))
    span, blocks = span_trace.host_clock(lambda: next(ticks))
    for _ in range(2):
        with span("lora.frames"):              # reads 0, 1 (then 10, 11)
            pass
        with span("lora.gateway"):             # 2 .. 9
            with span("lora.sf"):              # 3 .. 8
                with span("lora.pool"):        # 4, 5
                    pass
                with span("lora.phaseb"):      # 6, 7
                    pass
    want = {"lora.frames": [1e3], "lora.pool": [1e3], "lora.phaseb": [1e3],
            "lora.sf": [3e3], "lora.gateway": [2e3]}
    assert blocks == [want, want]
    mean = span_trace.mean_ms(blocks + [dict(want, **{"lora.sf": [1e3, 2e3]})])
    assert mean["total"]["lora.*"] == pytest.approx(8e3)
    assert list(mean["total"])[0] == "lora.sf"
    assert mean["calls"]["lora.pool"] == pytest.approx([1e3])
    assert "lora.sf" not in mean["calls"]          # a block with two calls


def _reader(name):
    return run.metric_reader(name)


def test_tail_device_ms_reader():
    read = _reader("tail.device_ms")
    t = {"span_device_s": {"lora.tail": 0.024, "gw.phaseb.sf7": 0.1}, "blocks": 12,
         "span_calls": {}}
    assert read({"trace": t}) == pytest.approx(2.0)
    assert read({"trace": dict(t, span_device_s={"gw.phaseb.sf7": 0.1})}) is None
    assert read({"trace": None}) is None


def test_lane_yield_reader(monkeypatch):
    read = _reader("phaseb.lane_yield")
    monkeypatch.setattr(tracing, "_counts", Counter({
        "frames.lanes.sf7": 256, "frames.valid.sf7": 8, "frames.lanes.sf8": 256,
        "frames.valid.sf8": 9, "other.sf7": 3}))
    assert read({"trace": {"blocks": 2}}) == pytest.approx(100.0 * 17 / 512)
    assert read({"trace": None}) is None
    monkeypatch.setattr(tracing, "_counts", Counter({"other.sf7": 2}))
    assert read({"trace": {"blocks": 2}}) is None
