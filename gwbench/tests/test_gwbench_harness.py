"""The benchmark's own CPU tests: names resolve, the yardstick's
arithmetic, the end-to-end arithmetic, the trace reduction, and no JAX.

    python -m pytest gwbench/tests -q
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gwbench import run, trace, yardstick  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = run.load_cell(cell)
    assert spec["cfg"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = run.metric_reader(metric)
    spec = run.load_cell(BENCH["workloads"][0]["name"])
    ctx = dict(geo=run.geometry(spec["cfg"]), cfg=spec["cfg"], trace=None, enq_ms=[],
               frames_ms=[])
    assert read(ctx) is None


def test_configuration_files_are_the_benchmarks():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_fused_min_ops_hand_worked():
    # 64 channels, D = 64, 617 taps (16 Msps, 62.5 kHz transition), 1000 outputs:
    # 64 * 1000 * (6 * 64 + 4 * 617) = 64,000 * 2,852
    assert yardstick.fused_min_ops(64, 64, 617, 1000) == 182_528_000
    # the cell's whole block: the hop 2^29 plus the halo (SF10's packet region
    # (12 + 13 + 48) * 2048, two symbols, ceil(617/64) + 1) * 64 = 9,831,104
    # samples; (546,702,016 - 617) // 64 + 1 = 8,542,210 outputs
    geo = run.geometry(run.load_cell("us915_64ch.sparse_aligned")["cfg"])
    assert (geo["K"], geo["D"], geo["halo"], geo["n_out"]) == (617, 64, 9_831_104, 8_542_210)
    t = yardstick.channelizer_bound_s(64, 64, 617, geo["L"], geo["n_out"])
    assert t == pytest.approx(64 * 8_542_210 * 2852 / 67e12)     # operations bound it


def test_lag_bound_hand_worked():
    # 64 channels of 2^20 float32 samples, SF7's 256-sample rows, lags 1, 2, 4, 8:
    # bytes 64*2*2^20*4 + 64*9*4096*4 = 546,308,096 at 3.35 TB/s;
    # flops 4*64*4096*256 + 8*64*256*(4095+4094+4092+4088) = 2,413,953,024 at 67 TFLOP/s
    t = yardstick.lag_bound_s(64, 1 << 20, 4, 256, [1, 2, 4, 8])
    assert t == pytest.approx(546_308_096 / 3.35e12)
    assert 2_413_953_024 / 67e12 < t


def _records(times):
    """Drained records with enqueue start ``t0`` and frames done ``t1``."""
    return [(0, t0, t0, t1, t1, [], {}) for t0, t1 in times]


def test_end_to_end_over_steady_blocks():
    recs = _records([(0.05 * i, 0.05 * i + 0.15) for i in range(200)])
    e = run.end_to_end(recs, 1 << 29, 0.0, 10.0)
    assert e["gw_msps"] == pytest.approx(200 * (1 << 29) / 10.0 / 1e6)
    assert e["block_p95_ms"] == pytest.approx(150.0)


def test_end_to_end_shows_a_stall():
    times = [(0.05 * i, 0.05 * i + 0.15) for i in range(200)]
    stalled = times[:100] + [(t0 + 2.0, t1 + 2.0) for t0, t1 in times[100:160]]
    stalled[99] = (stalled[99][0], stalled[99][1] + 2.0)   # the block the stall held
    e = run.end_to_end(_records(stalled), 1 << 29, 0.0, 10.0)
    assert e["gw_msps"] == pytest.approx(160 * (1 << 29) / 10.0 / 1e6)
    assert e["block_p95_ms"] == pytest.approx(150.0)
    held = [(t0, t1 + 2.0 if i >= 150 else t1) for i, (t0, t1) in enumerate(times)]
    assert run.end_to_end(_records(held), 1 << 29, 0.0, 10.0)["block_p95_ms"] > 2000.0


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def test_trace_reduction(tmp_path):
    ev = [_event("user_annotation", "gwbench.window", 0, 1000),
          _event("user_annotation", "gw.channel_planes", 10, 30),
          _event("cpu_op", "aten::mul", 15, 5),
          _event("cuda_runtime", "cudaLaunchKernel", 16, 2, correlation=1),
          _event("cpu_op", "aten::add", 200, 5),
          _event("cuda_runtime", "cudaLaunchKernel", 201, 2, correlation=2),
          _event("kernel", "k_chan", 20, 100, tid=7, correlation=1),
          _event("kernel", "k_add", 300, 50, tid=7, correlation=2),
          _event("gpu_memcpy", "Memcpy DtoH", 340, 20, tid=7, correlation=3)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    out = trace.reduce(str(p), "gwbench.window")
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(160e-6)       # [20, 120) and [300, 360)
    assert out["span_device_s"] == {"gwbench.window": pytest.approx(150e-6),
                                    "gw.channel_planes": pytest.approx(100e-6)}
    assert out["span_calls"]["gw.channel_planes"] == 1
    assert out["idle_gaps"] == [["aten::add", pytest.approx(180e-6)]]
    assert out["device_ops"][0] == ["k_chan", pytest.approx(100e-6)]
    assert out["launches"] == 2


FORBIDDEN = {"jax", "jaxlib", "flax", "lora_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "gwbench").rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
    # whole top-level names: the port is not the JAX package
    assert "lora_tpu_torch".split(".")[0] not in FORBIDDEN


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import gwbench.run, gwbench.traffic, "
            "gwbench.reference, gwbench.trace, gwbench.yardstick, lora_tpu_torch.plans; "
            "from gwbench import run; [run.metric_reader(m) for m in %r]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(ROOT), [m["name"] for m in BENCH["per_layer"]], FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "gwbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
