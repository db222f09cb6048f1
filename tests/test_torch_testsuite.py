"""The port's suite generator, runner, second modulator, SigMF I/O and
suite commands against lora_tpu's.

The generator is host numpy in both packages, so a suite is held
byte-equal: every ``.sigmf-data`` and ``.sigmf-meta`` file the port
writes for ``mini``, ``mini_alt``, ``mini_sdr`` and ``mini_implicit`` at
SF7 equals JAX's. ``tx.altmod`` is held sample-equal to JAX's; SigMF
files round-trip. The port's ``run_suite`` reaches 1.0 with the golden and
the dense engine on the CPU, as tests/test_testsuite_variants.py asks of
JAX's; its reports carry the device as their backend. The
``gen-suite``/``testsuite``/``decode-file`` commands print what JAX's
print."""

import os
from pathlib import Path

import numpy as np
import pytest

from lora_tpu import LoRaConfig as JConfig
from lora_tpu import cli as jcli
from lora_tpu import testsuite as jts
from lora_tpu.tx import altmod as jaltmod

from lora_tpu_torch import LoRaConfig
from lora_tpu_torch import cli, testsuite
from lora_tpu_torch.io.sigmf import list_suite, read_trace, write_trace
from lora_tpu_torch.tx import altmod

MINI = dict(sfs=(7,), crs=(4, 1), samp_rate=1e6)


def _files(d: Path):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


@pytest.mark.parametrize("suite", ["mini", "mini_alt", "mini_sdr", "mini_implicit"])
def test_generated_suite_is_byte_equal_to_jax(tmp_path, suite):
    a, b = tmp_path / "port", tmp_path / "jax"
    testsuite.generate_suite(str(a), suite, **MINI)
    jts.generate_suite(str(b), suite, **MINI)
    files = _files(a)
    assert files == _files(b) and len(files) == 2 * 3 * len(MINI["crs"])
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_altmod_matches_jax():
    cfg = JConfig(sf=8, cr=2, samp_rate=500e3, crc=True, sync_word=0x12)
    kw = dict(pad_before=1000, pad_after=300, snr_db=15.0, cfo_hz=250.0, drift_ppm=20.0,
              seed=7)
    got = altmod.modulate_frame_alt(LoRaConfig(sf=8, cr=2, samp_rate=500e3, crc=True,
                                               sync_word=0x12), b"\x01\x02\x03", **kw)
    want = jaltmod.modulate_frame_alt(cfg, b"\x01\x02\x03", **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        altmod.encode_symbols(LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True), b"\xca\xfe"),
        jaltmod.encode_symbols(JConfig(sf=7, cr=4, samp_rate=1e6, crc=True), b"\xca\xfe"))


def test_sigmf_roundtrip(tmp_path):
    cfg = LoRaConfig(sf=9, cr=3, samp_rate=1e6, crc=True, conj=True, sync_word=0x34)
    x = (np.arange(64) * (1 + 0.5j)).astype(np.complex64)
    stem = str(tmp_path / "t")
    meta = write_trace(stem, x, 1e6, config=cfg, capture_freq=868.1e6,
                       transmit_freq=868.3e6, expected="cafe", times=3)
    trace = read_trace(meta)
    np.testing.assert_array_equal(trace.samples, x)
    got = trace.lora_config
    assert (got.sf, got.cr, got.conj, got.sync_word, got.crc) == (9, 3, True, 0x34, True)
    assert (trace.expected, trace.times, trace.frequency_offset) == ("cafe", 3, 200e3)
    assert list_suite(str(tmp_path)) == [meta]


def test_implicit_expected_hex_matches_jax():
    for sf, cr, payload in [(7, 4, "cafe0102"), (7, 4, "88"), (8, 1, "deadbeef"),
                            (7, 2, "ffff"), (11, 3, "0011223344")]:
        kw = dict(sf=sf, cr=cr, samp_rate=250e3, crc=False, implicit=True,
                  reduced_rate=sf > 10)
        assert testsuite.implicit_expected_hex(LoRaConfig(**kw), bytes.fromhex(payload)) == \
            jts.implicit_expected_hex(JConfig(**kw), bytes.fromhex(payload))


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    d = tmp_path_factory.mktemp("suites")
    for suite in ("mini", "mini_implicit", "mini_sdr"):
        testsuite.generate_suite(str(d), suite, **dict(MINI, crs=(4,)))
    return d


@pytest.mark.parametrize("engine", ["golden", "dense"])
def test_run_suite_full_accuracy(suites, tmp_path, engine):
    res = testsuite.run_suite(str(suites), ("mini", "mini_implicit", "mini_sdr"),
                              reports_path=str(tmp_path), engine=engine,
                              report_suffix=f"_{engine}", device="cpu")
    assert res == {"mini": 1.0, "mini_implicit": 1.0, "mini_sdr": 1.0}, res
    report = (tmp_path / f"mini_{engine}.md").read_text()
    assert f"*Backend: {'numpy' if engine == 'golden' else 'cpu'}*" in report
    assert "Total payloads passed: 16 out of 16 (100.00%)" in report


def test_suite_commands_match_jax(suites, tmp_path, capsys):
    """``gen-suite`` writes the suite JAX's command writes; ``testsuite``
    prints what JAX's prints (golden engine). ``decode-file`` of a downlink
    (``lora:conj``) trace decodes its five frames, where JAX's command
    reads only ``--conj`` and decodes none; of an uplink trace it prints
    JAX's lines, on either engine."""
    out = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / name
        assert main(["gen-suite", str(d), "--suite", "mini_conj", "--sfs", "7",
                     "--crs", "4"]) == 0
        assert capsys.readouterr().out.strip() == str(d / "mini_conj")
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["testsuite", str(d), "--nowrite", "--min-accuracy", "1.0", *extra]) == 0
        text = capsys.readouterr().out.replace(str(d), "DIR")
        meta = sorted((d / "mini_conj").glob("*.sigmf-meta"))[0]
        assert main(["decode-file", str(meta), *extra]) == 0
        out[name] = ([line for line in text.splitlines() if "results on" not in line],
                     capsys.readouterr().out)
    assert out["port"][0] == out["jax"][0]
    for f in _files(tmp_path / "port"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert out["port"][1].splitlines() == ["04 90 40 de ad be ef 80 ec"] * 5
    assert out["jax"][1] == ""
    meta = str(sorted(Path(suites, "mini").glob("*.sigmf-meta"))[0])
    assert jcli.main(["decode-file", meta]) == 0
    want = capsys.readouterr().out.splitlines()
    assert want == ["04 90 40 de ad be ef 80 ec"] * 5
    for engine in ("golden", "dense", "parity"):
        assert cli.main(["decode-file", meta, "--engine", engine, "--device", "cpu"]) == 0
        assert capsys.readouterr().out.splitlines() == want
    assert cli.main(["decode-file", str(tmp_path / "missing.cf32"), "--device", "cpu"]) == 2
    assert cli.main(["testsuite", str(suites), "mini", "--engine", "parity", "--device", "cpu",
                     "--nowrite", "--min-accuracy", "1.0"]) == 0
    assert "Total payloads passed:    16 out of 16     (100.00%)" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "test-results")


def test_suite_matrix_tool_on_cpu(tmp_path):
    """``tools.suite_matrix``: a suite generated, run, counted and deleted,
    its report and the index written; the matrix is the JAX scripts'
    13 suites."""
    from lora_tpu_torch.tools import suite_matrix

    assert [s for s, _ in suite_matrix.MATRIX] == [
        "short_sim", "decode_long_sim", "short_sim_cfo500", "short_sim_conj",
        "short_sim_drift", "short_sim_drift10", "short_sim_implicit", "short_sim_sf13",
        "short_sim_sf6_implicit", "short_sim_snr10", "short_sim_sync12", "short_sim_sdr",
        "short_sim_alt"]
    work, reports = tmp_path / "work", tmp_path / "reports"
    row = suite_matrix.run_one("mini_alt", str(work), str(reports), "dense", "cpu",
                               sfs=(7,), crs=(4,))
    assert (row["suite"], row["passed"], row["total"], row["accuracy"]) == \
        ("mini_alt", 16, 16, 1.0)
    assert not (work / "mini_alt").exists() and (reports / "mini_alt_dense.md").exists()
    index = suite_matrix.write_index(str(reports), [row], "dense", "cpu")
    text = Path(index).read_text()
    assert "| [mini_alt_dense.md](mini_alt_dense.md) | 16 | 16 | 100.00% |" in text
