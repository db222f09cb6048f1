"""The port's spans and counters (``lora_tpu_torch.tracing``) on a small
plan gateway, on the CPU: outputs bit-equal with a profiler recording and
without one, no ``record_function`` entered without one, the spans nested
in the exported trace, and the frame counters equal to the results they
count.

The gateway: EU868 at 867.3 MHz, 1 Msps (three channels), SF7 and SF8,
one clean packet at each SF.
"""

import json

import numpy as np
import pytest
import torch

from lora_tpu_torch import LoRaConfig, PlanGateway, tracing
from lora_tpu_torch.tx.modulator import modulate_frame
from lora_tpu_torch.wideband import _frames_from_pooled

CENTER, RATE = 867.3e6, 1e6
SPS8 = int(2 ** 8 * RATE / 125e3)
PLACEMENTS = [(7, 867.1e6, b"\x42\x43", 2 * SPS8), (8, 867.5e6, b"\x24", 14 * SPS8)]

# each span and the span it runs in
PARENT = {"lora.channelize": "lora.gateway", "lora.cast": "lora.gateway",
          "lora.detect": "lora.gateway", "lora.sf": "lora.gateway",
          "lora.pool": "lora.sf", "lora.phaseb": "lora.sf", "lora.tail": "lora.phaseb"}


def _capture():
    rng = np.random.default_rng(7)
    L = 60 * SPS8
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for sf, f_abs, payload, pos in PLACEMENTS:
        pkt = modulate_frame(LoRaConfig(sf=sf, cr=4, samp_rate=RATE, crc=True,
                                        sync_word=0x34), payload)
        x[pos:pos + len(pkt)] += (pkt * np.exp(
            2j * np.pi * (f_abs - CENTER) / RATE * t[pos:pos + len(pkt)])).astype(np.complex64)
    return x


@pytest.fixture(scope="module")
def gw():
    return PlanGateway("EU868", CENTER, RATE, sfs=(7, 8), pool=8, max_candidates=2,
                       max_symbols=16, sfd_search=10, demod_method="fft", device="cpu")


@pytest.fixture(scope="module")
def capture():
    return _capture()


def _frames(gw, results):
    idx = np.arange(len(gw.channels))
    return [(sf, f.channel, f.sample_index, f.payload, f.snr, f.cfo)
            for sf in gw.sfs
            for f in _frames_from_pooled(results[sf], idx, gw.rxs[sf].cfg,
                                         np.zeros(len(gw.channels)))]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_outputs_bit_equal_with_and_without_a_profiler(gw, capture):
    plain = gw.process(capture)
    frames = _frames(gw, plain)
    decoded = {sf: p for sf, _, _, p, _, _ in frames}
    assert len(frames) == len(PLACEMENTS)
    for sf, _, payload, _ in PLACEMENTS:
        assert decoded[sf][:len(payload)] == payload

    def decode():
        r = gw.process(capture)
        return r, _frames(gw, r)

    (traced, traced_frames), _ = _profiled(decode)
    for sf in gw.sfs:
        for name, a, b in zip(plain[sf]._fields, plain[sf], traced[sf]):
            assert a.dtype == b.dtype and torch.equal(a, b), (sf, name)
    assert traced_frames == frames


def test_no_record_function_without_a_profiler(gw, capture, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("lora.gateway") is tracing.span("lora.tail")
    _frames(gw, gw.process(capture))


def test_the_trace_holds_the_spans_nested(gw, capture, tmp_path):
    _, prof = _profiled(lambda: _frames(gw, gw.process(capture)))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("lora.")]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    n_sf = len(gw.sfs)
    assert {k: len(v) for k, v in by_name.items()} == {
        "lora.gateway": 1, "lora.channelize": 1, "lora.cast": 1, "lora.detect": 1,
        "lora.sf": n_sf, "lora.pool": n_sf, "lora.phaseb": n_sf, "lora.tail": n_sf,
        "lora.frames": n_sf}
    inside = lambda a, b: (a["tid"] == b["tid"] and b["ts"] <= a["ts"]
                           and a["ts"] + a["dur"] <= b["ts"] + b["dur"])
    for child, parent in PARENT.items():
        for e in by_name[child]:
            assert any(inside(e, p) for p in by_name[parent]), (child, parent)
    # the frames are built after the gateway's call, outside it
    root = by_name["lora.gateway"][0]
    assert all(not inside(e, root) for e in by_name["lora.frames"])
    # each SF's stage holds one pool, one Phase B and one tail
    for s in by_name["lora.sf"]:
        for name in ("lora.pool", "lora.phaseb", "lora.tail"):
            assert sum(inside(e, s) for e in by_name[name]) == 1, name


def test_frame_counters_equal_the_results(gw, capture):
    results = gw.process(capture)
    before = tracing.counters()
    _frames(gw, results)
    delta = tracing.counters()
    delta.subtract(before)
    for sf in gw.sfs:
        r = results[sf]
        assert delta[f"frames.lanes.sf{sf}"] == r.valid.numel() == gw.pool
        assert delta[f"frames.valid.sf{sf}"] == int(r.valid.sum()) == 1
    assert {k for k, v in delta.items() if v} == {
        f"frames.{n}.sf{sf}" for n in ("lanes", "valid") for sf in gw.sfs}
    # the gateway's call counts nothing: only the frame builder does
    before = tracing.counters()
    gw.process(capture)
    assert tracing.counters() == before


def test_counters_returns_a_copy():
    c = tracing.counters()
    c["frames.lanes.sf7"] += 1000
    assert tracing.counters()["frames.lanes.sf7"] == c["frames.lanes.sf7"] - 1000
