"""``python -m lora_tpu_torch.cli gateway`` against ``lora_tpu.cli gateway``
on the same cf32 files, on the CPU (``--device cpu``): the same frame
lines and summary, for the multi-SF PFB gateway and the EU868 plan, each
in one call and with ``--stream`` over block seams (mirrors
tests/test_cli.py:59-126); the UDP sink on a port of the kernel's choice;
``--implicit`` raises until implicit headers are ported. ``blocks`` prints
JAX's YAML byte for byte; ``flowgraph`` prints JAX's frame lines and
summary for a graph of examples/lora_receive_file.yml's shape; ``analyze``
prints what JAX's prints for the same debugger client."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lora_tpu.channelizer import pfb_channel_freqs
from lora_tpu.cli import main as jmain
from lora_tpu.config import LoRaConfig
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch.cli import main
from lora_tpu_torch.io.udp import LoRaUDPServer

ROOT = Path(__file__).resolve().parent.parent
M, CHAN_RATE = 8, 250e3
WIDE_RATE = M * CHAN_RATE
CENTER, RATE = 868.3e6, 2e6


def _pfb_capture(path, placements, L, seed=3):
    """A PFB-grid wideband capture: ``(sf, channel, wideband position,
    payload)`` packets over noise (sigma 1e-4 a part)."""
    freqs = pfb_channel_freqs(WIDE_RATE, M)
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for sf, chan, pos, payload in placements:
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=WIDE_RATE, crc=True)
        pkt = modulate_frame(wcfg, payload, snr_db=None)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * freqs[chan] / WIDE_RATE
                                               * t[pos:pos + len(pkt)])).astype(np.complex64)
    x.tofile(path)
    return str(path)


def _plan_capture(path, placements, L, seed=9):
    """An EU868 capture at 868.3 MHz, 2 Msps: ``(sf, frequency, wideband
    position, payload)`` packets over noise (sigma 1e-4 a part)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for sf, f_abs, pos, payload in placements:
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=RATE, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, payload, snr_db=None)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (f_abs - CENTER) / RATE
                                               * t[pos:pos + len(pkt)])).astype(np.complex64)
    x.tofile(path)
    return str(path)


SPS9 = int(4 * 2 ** 7 * CHAN_RATE / 125e3)      # SF9 symbol at the channel rate
SPS8 = int(2 ** 8 * RATE / 125e3)               # SF8 symbol at the plan's wideband rate
CASES = {
    # tests/test_cli.py:59: SF7 and SF9 packets, one call
    "multi-sf": (_pfb_capture, [(7, 2, 2 * 256 * M, b"\xca\xfe"),
                                (9, 5, 2 * SPS9 * M, b"\xf0\x0d")],
                 M * 40 * SPS9, ["--samp-rate", str(WIDE_RATE), "--channels", str(M),
                                 "--sfs", "7", "8", "9", "--pool", "8"]),
    # the same over three blocks of 80 SF9 symbols: the SF9 packet across
    # the first seam, an SF8 packet in the second block
    "multi-sf-long": (_pfb_capture, [(7, 2, 2 * 256 * M, b"\xca\xfe"),
                                     (9, 5, 76 * SPS9 * M, b"\xf0\x0d"),
                                     (8, 3, 100 * SPS9 * M, b"\xbe\xef")],
                      M * 200 * SPS9, ["--samp-rate", str(WIDE_RATE), "--channels", str(M),
                                       "--sfs", "7", "8", "9", "--pool", "8",
                                       "--block-symbols", "80"]),
    # tests/test_cli.py:100: one SF7 packet on 868.1 MHz
    "plan": (_plan_capture, [(7, 868.1e6, 2 * 2 ** 7 * 16, b"\xaa\x55")], 40 * SPS8,
             ["--plan", "EU868", "--center-freq", str(CENTER), "--samp-rate", str(RATE),
              "--sfs", "7", "--pool", "8"]),
    # SF7 and SF8 over three blocks of 80 SF8 symbols, the SF8 packet
    # across the first seam
    "plan-long": (_plan_capture, [(7, 868.1e6, 2 * 2 ** 7 * 16, b"\xaa\x55"),
                                  (8, 868.5e6, 76 * SPS8, b"\x24\x25"),
                                  (7, 867.9e6, 130 * SPS8, b"\x5a")], 240 * SPS8,
                  ["--plan", "EU868", "--center-freq", str(CENTER), "--samp-rate", str(RATE),
                   "--sfs", "7", "8", "--pool", "8", "--block-symbols", "80"]),
}


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    cap = capsys.readouterr()
    return cap.out.strip().splitlines(), cap.err.strip().splitlines()


@pytest.mark.parametrize("case,stream", [("multi-sf", False), ("multi-sf-long", False),
                                         ("multi-sf-long", True), ("plan", False),
                                         ("plan-long", False), ("plan-long", True)])
def test_gateway_prints_jax_lines(tmp_path, capsys, case, stream):
    build, placements, L, args = CASES[case]
    f = build(tmp_path / "capture.cf32", placements, L)
    argv = ["gateway", f, *args] + (["--stream"] if stream else [])
    want, want_err = _run(jmain, argv, capsys)
    got, got_err = _run(main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert got_err[-1:] == want_err[-1:]
    assert len(got) == len(placements)
    for sf, _, _, payload in placements:
        assert any(line.split()[1] == f"sf{sf}" and payload.hex() in "".join(line.split()[3:])
                   for line in got)


def test_gateway_stream_equals_one_call(tmp_path, capsys):
    build, placements, L, args = CASES["plan-long"]
    f = build(tmp_path / "capture.cf32", placements, L)
    one, _ = _run(main, ["gateway", f, *args, "--device", "cpu"], capsys)
    streamed, _ = _run(main, ["gateway", f, *args, "--device", "cpu", "--stream"], capsys)
    assert sorted(streamed) == sorted(one)


def test_gateway_udp_sink(tmp_path, capsys):
    """``--udp`` sends each frame at ``--layer`` (LORAMAC here) to the
    server, as JAX's command sends it."""
    build, placements, L, args = CASES["multi-sf"]
    f = build(tmp_path / "capture.cf32", placements, L)
    got = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]), ("jax", jmain, [])):
        with LoRaUDPServer(port=0, timeout=5.0) as server:
            _run(fn, ["gateway", f, *args, "--udp", "--udp-port", str(server.port),
                      "--layer", "2", *extra], capsys)
            got[name] = server.get_payloads(2)
    assert got["port"] == got["jax"] == [b"cafe", b"f00d"]


def test_gateway_shell_entry_and_errors(tmp_path):
    """``python -m lora_tpu_torch.cli gateway``: the frame lines from the
    shell; a missing file exits 2; ``--implicit`` builds implicit-header
    receivers and decodes the capture with them."""
    build, placements, L, args = CASES["plan"]
    f = build(tmp_path / "capture.cf32", placements, L)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "lora_tpu_torch.cli", "gateway", f, *args,
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].split()[:3] == ["ch0", "sf7", "868100000Hz"]
    assert "aa55" in "".join(lines[0].split()[3:])
    assert main(["gateway", str(tmp_path / "missing.cf32"), "--device", "cpu"]) == 2
    assert main(["gateway", f, *args, "--implicit", "--device", "cpu"]) == 0


@pytest.mark.parametrize("block", [None, "lora_receiver", "lora_lora_gateway",
                                   "message_mongodb_sink"])
def test_blocks_prints_jax_yaml(capsys, block):
    """``blocks [BLOCK]``: the descriptor YAML, byte-equal to JAX's (12
    descriptors in all)."""
    args = ["blocks"] + ([block] if block else [])
    assert main(args) == 0
    got = capsys.readouterr().out
    assert jmain(args) == 0
    assert got == capsys.readouterr().out
    assert got.count("\nid: lora_") + got.startswith("id: lora_") == (12 if block is None else 1)


def test_blocks_unknown_block(capsys):
    assert main(["blocks", "warp_drive"]) == jmain(["blocks", "warp_drive"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err == ["unknown block 'warp_drive'"] * 2


def test_flowgraph_command_prints_jax_lines(tmp_path, capsys):
    """``flowgraph FILE --device cpu``: a graph of the shape of
    examples/lora_receive_file.yml (a channel 100 kHz off the capture's
    center, a print sink at the LoRaPHY layer): the same frame lines and
    the same summary as ``lora_tpu.cli flowgraph``."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = cfg.samples_per_symbol
    x = np.concatenate([modulate_frame(cfg, bytes([k, 0xEE]), pad_before=3000,
                                       pad_after=2 * sps, snr_db=40.0, seed=k)
                        for k in range(2)] + [np.zeros(4 * sps, np.complex64)])
    t = np.arange(len(x))
    (x * np.exp(2j * np.pi * 100e3 / 1e6 * t)).astype(np.complex64).tofile(tmp_path / "c.cf32")
    y = tmp_path / "g.yml"
    y.write_text(f"""
options: {{id: lora_receive_file}}
variables: {{samp_rate: 1e6, capture_freq: 868.0e6, offset: 100e3}}
blocks:
- {{name: src, id: file_source, parameters: {{file: {tmp_path / 'c.cf32'}}}}}
- {{name: throttle, id: throttle, parameters: {{samp_rate: samp_rate * 100}}}}
- name: lora_rx
  id: lora_receiver
  parameters: {{samp_rate: samp_rate, center_freq: capture_freq,
               channel_list: [capture_freq + offset], sf: 7, cr: 4, crc: True}}
- {{name: printer, id: frame_print_sink, parameters: {{layer: 1}}}}
connections:
- [src, '0', throttle, '0']
- [throttle, '0', lora_rx, '0']
- [lora_rx, frames, printer, in]
""")
    assert main(["flowgraph", str(y), "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert jmain(["flowgraph", str(y)]) == 0
    want = capsys.readouterr()
    assert got.out.splitlines() == want.out.splitlines()
    assert [line.split()[3:5] for line in got.out.splitlines()] == [["00", "ee"], ["01", "ee"]]
    assert got.err.splitlines()[-1] == want.err.splitlines()[-1] == "decoded 2 frames"


def test_analyze_command_matches_jax(tmp_path, capsys):
    """``analyze --socket PATH --max-buffers 2`` against a
    ``SampleDebugger`` client: it takes two buffers and prints what JAX's
    command prints."""
    import threading
    import time

    from lora_tpu_torch.debugger import SampleDebugger

    out = {}
    for name, entry in (("port", main), ("jax", jmain)):
        path = str(tmp_path / f"{name}.sock")

        def client():
            d = SampleDebugger()
            for _ in range(200):
                d.attach(path)
                if d.attached:
                    break
                time.sleep(0.02)
            for k in range(3):
                d.store_samples(np.exp(1j * np.arange(64) * 0.1 * (k + 1)).astype(np.complex64))
                d.analyze_samples()
            d.detach()

        t = threading.Thread(target=client)
        t.start()
        assert entry(["analyze", "--socket", path, "--max-buffers", "2"]) == 0
        t.join()
        out[name] = capsys.readouterr().out.replace(path, "PATH")
    assert out["port"] == out["jax"] and out["port"].startswith("listening on PATH")
