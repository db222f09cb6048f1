"""The port's per-stage timing study on the CPU, at tests/test_profiling.py's
sizes: every stage runs and gives a positive per-unit time, the table
keeps the reference's shape and names its device, and the ``timings``
CLI prints it. A CPU time is the CPU's, no device metric."""

import subprocess
import sys
from pathlib import Path

import pytest

from lora_tpu_torch import cli
from lora_tpu_torch.ops.cuda_kernels import detection_metrics_kernel
from lora_tpu_torch.profiling import REF_MS, pfb_timings, stage_timings, timing_table

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("method,stages", [
    ("fft", ("detect", "sync", "sfd", "demod", "decode")),
    ("gradient", ("detect", "sync", "sync_parity", "sfd", "demod", "decode")),
])
def test_stage_timings_all_stages(method, stages):
    before = detection_metrics_kernel.launches
    t = stage_timings(sf=7, method=method, batch_windows=64, batch_symbols=16,
                      batch_frames=4, iters=1, device="cpu")
    assert detection_metrics_kernel.launches == before     # the CPU runs the plain version
    for stage in stages:
        assert t[stage] > 0.0, stage
    assert set(t) == set(stages) | {"samples_per_symbol"}
    assert t["samples_per_symbol"] == 1024


def test_timing_table_format():
    got = {}
    table = timing_table(sfs=(7,), methods=("fft",), iters=1, device="cpu", timings=got)
    assert list(got) == [(7, "fft")] and got[(7, "fft")]["demod"] > 0.0
    assert table.startswith("# Per-stage receiver timings (cpu)")
    assert "| SF | method | stage |" in table
    assert "| 7 | fft | demod | symbol |" in table
    assert f"| {REF_MS[(7, 'fft', 'demod')]:.4f} |" in table


def test_stage_timings_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_timings(sf=7, method="fft", batch_windows=4, batch_symbols=4, batch_frames=1,
                      iters=1)


def test_pfb_timings_on_cpu():
    t = pfb_timings(n_channels=8, block_symbols=4, iters=1, device="cpu")
    assert set(t) == {"pfb_f32", "pfb_bf16"} and min(t.values()) > 0.0


def test_tools_raise_without_a_card():
    import torch

    from lora_tpu_torch.tools import profile_detect, profile_packing

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for tool in (profile_detect, profile_packing):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])


def test_cli_timings(tmp_path, capsys):
    out = tmp_path / "t.md"
    assert cli.main(["timings", "--device", "cpu", "--sfs", "7", "--methods", "fft",
                     "--iters", "1", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "| 7 | fft | detect | window |" in printed
    assert out.read_text() == printed[:-1]      # print adds one newline


def test_cli_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "lora_tpu_torch.cli", "timings", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
