"""``lora_tpu_torch.bench`` against the repo-root ``bench.py``, on the CPU.

Captures: each ``bench.py`` stage runs with ``lora_tpu.ops.xfer.pack_iq``
replaced by a recorder that keeps its input and the stage's locals and
stops it (``bench.py`` imports ``pack_iq`` inside the stage), so neither
``bench.py`` nor ``lora_tpu`` is edited; the port's capture builder must
give the same capture. The noise is bit-equal, and so is every capture
but the full-occupancy one: its complex64 phasor recurrence rounds its
products in another order than numpy's (which fuses a multiply-add), so
the running phasor drifts apart by a few float32 ulps a channel; its
tolerance is ``8 * M * 2^-24`` of the packet's unit amplitude. Active
channels, placements and expectations are equal.

Stages: each runs small (one round of one call) and prints one line a
metric with ``bench.py``'s name and keys and ``decode_ratio`` 1.0; a
capture whose payload is altered fails the gate with no line; the
orchestrator runs every stage and names each that failed or ran out of
time; ``cli bench`` parses as ``lora_tpu.cli bench`` does and runs the
dense stage only."""

import ast
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lora_tpu.cli as jcli
import lora_tpu.ops.xfer as jxfer

from lora_tpu_torch import LoRaConfig, MultiSFWidebandReceiver, PlanGateway
from lora_tpu_torch import bench as pb
from lora_tpu_torch.cli import main as cli

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("bench_py", ROOT / "bench.py")
bench_py = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_py)


class _Stop(Exception):
    pass


def record_bench_py(monkeypatch, fn, *args, **kw) -> dict:
    """Run ``bench.py``'s stage ``fn`` up to its ``pack_iq`` call: the
    capture it would pack (``"x"``) and the stage's locals there."""
    rec = {}

    def recorder(x, dtype=None):
        rec["x"] = np.array(x)
        rec["locals"] = dict(inspect.currentframe().f_back.f_locals)
        raise _Stop

    monkeypatch.setattr(jxfer, "pack_iq", recorder)
    with pytest.raises(_Stop):
        fn(*args, **kw)
    return rec


def port_gateway(M, sfs):
    return MultiSFWidebandReceiver(LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True), M,
                                   sfs=sfs, pool=48, device="cpu", **pb._KW)


def port_plan(plan, sfs=pb.GATEWAY_SFS):
    center, rate = pb.PLAN_GEOMS.get(plan, pb.EU868_GEOM)
    return PlanGateway(plan, center, rate, sfs=sfs, pool=24, device="cpu", **pb._KW)


def _bench_noise(L):
    """``bench.py``'s noise expression, verbatim."""
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1e-3, (L, 2)).astype(np.float32)
            @ np.array([1, 1j], np.complex64)).astype(np.complex64)


@pytest.mark.parametrize("stage", ["dense", "wideband", "full", "gateway", "plan"])
def test_capture_matches_bench_py(monkeypatch, stage):
    M = 16
    if stage == "dense":
        monkeypatch.setattr(sys, "argv", ["bench.py", "2"])
        rec = record_bench_py(monkeypatch, bench_py.main)
        _, x, expected = pb.dense_capture(2)
        loc = rec["locals"]
        assert expected == loc["n_channels"] * min(8, loc["reps"]) == 16
        np.testing.assert_array_equal(x, rec["x"])
        return
    if stage == "wideband":
        rec = record_bench_py(monkeypatch, bench_py.main_wideband, M)
        _, x, active = pb.wideband_capture(M, "cpu")
        assert active == rec["locals"]["active"]
    elif stage == "full":
        rec = record_bench_py(monkeypatch, bench_py.main_wideband_full, M)
        _, x, active = pb.full_occupancy_capture(M, "cpu")
        assert active == list(range(M))
    elif stage == "gateway":
        rec = record_bench_py(monkeypatch, bench_py.main_gateway, 8, sfs=(7, 8))
        x, expect = pb.gateway_capture(port_gateway(8, (7, 8)), "cpu")
        assert expect == set(rec["locals"]["expect"]) and len(expect) == 8
    else:
        rec = record_bench_py(monkeypatch, bench_py.main_plan_gateway, "EU868")
        x, expect = pb.plan_capture(port_plan("EU868"), "cpu")
        assert expect == rec["locals"]["expect"] and len(expect) == 7
    want, got = rec["x"], x.numpy()
    assert got.dtype == want.dtype == np.complex64 and got.shape == want.shape
    noise = pb.noise(len(want))
    np.testing.assert_array_equal(noise.view(np.uint32), _bench_noise(len(want)).view(np.uint32))
    untouched = want == noise   # samples no packet reached, in bench.py's capture
    assert untouched.mean() > 0.25
    np.testing.assert_array_equal(got[untouched].view(np.uint32), noise[untouched].view(np.uint32))
    if stage == "full":
        tol = 8 * M * 2.0 ** -24
        assert 0 < np.abs(got - want).max() <= tol
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# a stage at a small size: (stage function, its arguments, bench.py's keys a line)
_KEYS = ["metric", "value", "unit", "vs_baseline"]
SMALL = {
    "dense": (pb.main, dict(n_channels=2, block_symbols=128),
              [("dense_rx_throughput_bf16", _KEYS + ["decode_ratio"]),
               ("dense_rx_throughput", _KEYS)]),
    "wideband": (pb.main_wideband, dict(n_channels=16),
                 [("wideband_16ch_throughput", _KEYS + ["decode_ratio"])]),
    "full": (pb.main_wideband_full, dict(n_channels=16),
             [("wideband_16ch_full_occupancy_throughput", _KEYS + ["decode_ratio", "n_dropped"])]),
    "gateway": (pb.main_gateway, dict(n_channels=8, sfs=(7, 8)),
                [("gateway_8ch_2sf_throughput", _KEYS + ["decode_ratio", "demod_contexts"])]),
    "plan-eu868": (pb.main_plan_gateway, dict(plan="EU868", sfs=(7, 8)),
                   [("plan_gateway_eu868_2sf_throughput", _KEYS + ["decode_ratio", "channels"])]),
    "plan-us915": (pb.main_plan_gateway, dict(plan="US915", sfs=(7, 8)),
                   [("plan_gateway_us915_2sf_throughput", _KEYS + ["decode_ratio", "channels"])]),
}


@pytest.mark.parametrize("stage", sorted(SMALL))
def test_stage_prints_bench_lines(capsys, stage):
    fn, kw, want = SMALL[stage]
    res = fn(**kw, rounds=1, iters=1, device="cpu")
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == res.lines
    assert [(r["metric"], list(r)) for r in printed] == want
    assert len(res.rates) == len(printed)
    # the rate measured is positive and printed as bench.py prints it (one
    # decimal: a slow host call may print 0.0, so the unrounded rate is checked)
    for r, rate in zip(printed, res.rates):
        assert rate > 0 and r["value"] == round(rate, 1) and r["unit"] == "Msamples/s/chip"
        assert r["vs_baseline"] == r["value"]
        assert r.get("decode_ratio", 1.0) == 1.0 and r.get("n_dropped", 0) == 0
    assert all(len(lanes) > 0 for lanes in res.lanes)
    if stage == "gateway":
        assert printed[0]["demod_contexts"] == 16
    if stage.startswith("plan"):
        assert printed[0]["channels"] == {"plan-eu868": 7, "plan-us915": 23}[stage]


def _alter_payload(monkeypatch):
    """Every packet the bench modulates carries ``de ad be ee``."""
    modulate = pb.modulate_frame

    def altered(cfg, payload, **kw):
        return modulate(cfg, b"\xde\xad\xbe\xee" if payload == pb.DEADBEEF else payload, **kw)

    monkeypatch.setattr(pb, "modulate_frame", altered)


@pytest.mark.parametrize("stage", ["dense", "wideband", "full", "gateway", "plan-eu868"])
def test_altered_payload_fails_the_gate(monkeypatch, capsys, stage):
    _alter_payload(monkeypatch)
    fn, kw, _ = SMALL[stage]
    with pytest.raises(pb.GateFailure):
        fn(**kw, rounds=1, iters=1, device="cpu")
    assert capsys.readouterr().out == ""


def test_command_exits_nonzero_on_a_missed_gate(monkeypatch, capsys):
    _alter_payload(monkeypatch)
    assert pb.cli_main(["--wideband", "16", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "device: cpu" in err and "bench: FAIL: wideband M=16: channels [0, 1" in err


def _bench_py_stage_list():
    """``bench.py``'s ``_subprocess_stage(args, timeout)`` calls, in order."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return [(ast.literal_eval(n.args[0]), ast.literal_eval(n.args[1])) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "_subprocess_stage"]


@pytest.mark.parametrize("argv,dense", [([], ["--dense-only"]),
                                        (["8", "--no-bf16"], ["--dense-only", "8", "--no-bf16"])])
def test_orchestrator_runs_every_stage_and_names_failures(monkeypatch, capsys, argv, dense):
    assert [(list(f), t) for f, t in pb.STAGES] == _bench_py_stage_list()
    calls = []

    def fake_run(cmd, timeout, check, env):
        assert cmd[:3] == [sys.executable, "-m", "lora_tpu_torch.bench"]
        assert cmd[-2:] == ["--device", "cpu"] and not check
        assert str(ROOT) in env["PYTHONPATH"].split(":")
        flags = cmd[3:-2]
        calls.append((flags, timeout))
        if flags == ["--wideband", "1024"]:
            return subprocess.CompletedProcess(cmd, 1)
        if flags == ["--gateway", "256"]:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert pb.cli_main(argv + ["--device", "cpu"]) == 1
    assert calls == [(list(f), t) for f, t in pb.STAGES] + [(dense, pb.DENSE_TIMEOUT_S)]
    err = capsys.readouterr().err
    assert ("bench: FAIL: 2 of 8 stages: --wideband 1024: exit code 1; "
            "--gateway 256: timed out after 540 s") in err


def test_orchestrator_exits_zero_when_every_stage_passes(monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0))
    assert pb.cli_main(["--device", "cpu"]) == 0


@pytest.mark.parametrize("argv,stage,kw", [
    (["--wideband"], "main_wideband", dict(n_channels=1024)),
    (["--wideband", "256"], "main_wideband", dict(n_channels=256)),
    (["4096", "--wideband"], "main_wideband", dict(n_channels=4096)),
    (["--wideband-full"], "main_wideband_full", dict(n_channels=1024)),
    (["--gateway"], "main_gateway", dict(n_channels=256)),
    (["--plan-gateway"], "main_plan_gateway", dict(plan="EU868")),
    (["--plan-gateway", "US915"], "main_plan_gateway", dict(plan="US915")),
    (["--dense-only"], "main", dict(n_channels=64, bf16=True)),
    (["--dense-only", "8", "--no-bf16"], "main", dict(n_channels=8, bf16=False)),
])
def test_stage_flags_dispatch(monkeypatch, argv, stage, kw):
    seen = []
    for name in ("main", "main_wideband", "main_wideband_full", "main_gateway",
                 "main_plan_gateway"):
        monkeypatch.setattr(pb, name, lambda name=name, **k: seen.append((name, k)))
    assert pb.cli_main(argv + ["--device", "cpu"]) == 0
    assert seen == [(stage, dict(kw, device=torch.device("cpu")))]


@pytest.mark.parametrize("argv,channels", [([], 64), (["--channels", "8"], 8)])
def test_cli_bench_parses_as_jax_and_runs_the_dense_stage(monkeypatch, argv, channels):
    jax_args = []
    monkeypatch.setattr(jcli, "cmd_bench", lambda args: jax_args.append(args) or 0)
    assert jcli.main(["bench"] + argv) == 0
    assert (jax_args[0].channels or 64) == channels
    seen = []
    monkeypatch.setattr(pb, "main", lambda **k: seen.append(k))
    for name in ("main_wideband", "main_wideband_full", "main_gateway", "main_plan_gateway"):
        monkeypatch.setattr(pb, name, lambda **k: pytest.fail("not the dense stage"))
    assert cli(["bench"] + argv + ["--device", "cpu"]) == 0
    assert seen == [dict(n_channels=channels, bf16=True, device=torch.device("cpu"))]


def test_bench_defaults_to_the_card(monkeypatch):
    """No ``--device``: the card, or a raise without one (the stage
    functions too); nothing carries on on the CPU."""
    seen = []
    monkeypatch.setattr(pb, "main_wideband", lambda **k: seen.append(k["device"]))
    if torch.cuda.is_available():
        assert pb.cli_main(["--wideband", "16"]) == 0 and seen[0].type == "cuda"
        return
    for run in (lambda: pb.cli_main(["--wideband", "16"]), lambda: pb.cli_main([]),
                lambda: pb.main_gateway(8), lambda: pb.wideband_capture(16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert seen == []


def test_module_imports_no_bench_py():
    tree = ast.parse((ROOT / "lora_tpu_torch" / "bench.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if n.split(".")[0] in ("bench", "jax", "lora_tpu")]
