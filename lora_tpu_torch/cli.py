"""Command line of the PyTorch/CUDA port.

    python -m lora_tpu_torch.cli decode-file FILE [--engine golden|parity|dense]
                                         [--low-snr [auto]] [--sf 7 ...] [--device cpu]
    python -m lora_tpu_torch.cli gen-suite OUT [--suite short_sim] [--sfs 7 ... 12]
    python -m lora_tpu_torch.cli testsuite PATH [SUITE ...] [--engine golden|parity|dense]
                                         [--reports DIR] [--min-accuracy A] [--device cpu]
    python -m lora_tpu_torch.cli gateway FILE [--plan EU868 --center-freq HZ]
                                         [--samp-rate HZ] [--channels M] [--sfs 7 ... 12]
                                         [--stream [--block-symbols N]]
                                         [--udp [--udp-ip IP] [--udp-port P] [--layer L]]
                                         [--device cpu] ...
    python -m lora_tpu_torch.cli timings [--sfs 7 12] [--methods gradient fft]
                                         [--iters 5] [--out FILE] [--device cpu]
    python -m lora_tpu_torch.cli flowgraph FILE [--max-frames N] [--max-seconds S]
                                         [--device cpu]
    python -m lora_tpu_torch.cli blocks [BLOCK]
    python -m lora_tpu_torch.cli analyze [--socket PATH] [--max-buffers N]
    python -m lora_tpu_torch.cli bench [--channels N] [--device cpu]

``decode-file`` decodes a raw cf32 or SigMF capture through the receiver
facade (``LoRaReceiver``) and prints one line a frame, as ``lora_tpu.cli
decode-file`` does; ``gen-suite`` writes a hermetic SigMF suite
(byte-equal to the JAX package's); ``testsuite`` runs SigMF suites
through the facade and writes Markdown accuracy reports, exiting 1 when
a suite falls below ``--min-accuracy``. ``gateway`` decodes every channel
x every SF of a raw cf32 wideband capture (a PFB grid, or a LoRaWAN
regional plan with ``--plan``), in one call or, with ``--stream``, in
overlap-save blocks read from the file chunk by chunk, and prints one
line a frame, as ``lora_tpu.cli gateway`` does. ``timings`` prints the
per-stage timing study (:func:`lora_tpu_torch.profiling.timing_table`).
``flowgraph`` runs a YAML flowgraph (:mod:`lora_tpu_torch.flowgraph`),
``blocks`` prints the block descriptors as YAML (those of ``lora_tpu.cli
blocks``), and ``analyze`` runs the sample scope on a debugger socket
(:func:`lora_tpu_torch.debugger.live_analyze`). ``bench`` runs the dense
throughput stage of :mod:`lora_tpu_torch.bench` at ``--channels``
channels (64 by default) and prints its two JSON lines, bfloat16 then
float32, as ``lora_tpu.cli bench`` does; ``python -m
lora_tpu_torch.bench`` runs every stage. Each runs on the card, or on the
CPU with ``--device cpu`` (``gen-suite``, ``blocks`` and ``analyze`` run
on the host).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .debugger import DEFAULT_SOCK


def _low_snr_value(s: str):
    """--low-snr's optional value: only 'auto'; anything else (a typo, or a
    file name the optional value swallowed) is an error, not full coherent
    mode."""
    if s == "auto":
        return "auto"
    raise argparse.ArgumentTypeError(f"--low-snr takes no value or 'auto', got {s!r}")


def cmd_decode_file(args) -> int:
    """Decode one capture (raw cf32, or SigMF with its ``lora:*`` keys)."""
    from .io.sigmf import read_trace
    from .io.udp import MessageSocketSink
    from .receiver import LoRaReceiver

    if not os.path.exists(args.file):
        print(f"error: no such capture file: {args.file}", file=sys.stderr)
        return 2
    if args.file.endswith(".sigmf-meta"):
        trace = read_trace(args.file)
        samples = trace.samples
        samp_rate = trace.sample_rate
        cfg = trace.lora_config
        sf, cr, implicit, crc, reduced = cfg.sf, cfg.cr, cfg.implicit, cfg.crc, cfg.reduced_rate
        # a downlink trace's lora:conj key counts like its other lora:* keys
        # (JAX's command reads only --conj, and decodes no frame of one)
        conj = cfg.conj or args.conj
        center = trace.capture_freq
        channels = [trace.capture_freq + trace.frequency_offset]
    else:
        samples = np.fromfile(args.file, dtype=np.complex64)
        samp_rate = args.samp_rate
        sf, cr, implicit, crc = args.sf, args.cr, args.implicit, args.crc
        reduced, conj = args.reduced_rate, args.conj
        center = args.center_freq
        channels = [args.center_freq + args.offset]
    # --low-snr: the coherent mode of the dense fft engine
    engine = "dense" if args.low_snr else args.engine
    kw = {"low_snr": "auto" if args.low_snr == "auto" else True} if args.low_snr else {}
    rx = LoRaReceiver(
        samp_rate=samp_rate, center_freq=center, channel_list=channels,
        bandwidth=args.bandwidth, sf=sf, implicit=implicit, cr=cr, crc=crc,
        reduced_rate=reduced, conj=conj, decimation=args.decimation,
        disable_drift_correction=args.no_drift_correction, engine=engine,
        device=args.device, **kw)
    frames = rx.receive(samples)
    sink = MessageSocketSink(args.udp_ip, args.udp_port, args.layer) if args.udp else None
    for f in frames:
        data = f.to_bytes(1)  # LORAPHY layer, like the demo's printout
        print(" ".join(f"{b:02x}" for b in data))
        if sink:
            sink.handle(f)
    if sink:
        sink.close()
    print(f"decoded {len(frames)} frames", file=sys.stderr)
    return 0


def cmd_testsuite(args) -> int:
    from .testsuite import run_suite

    results = run_suite(
        args.path, args.suites, reports_path=args.reports,
        engine=args.engine, write_output=not args.nowrite,
        report_suffix="" if args.engine == "golden" else f"_{args.engine}",
        device=args.device)
    return 0 if all(v >= args.min_accuracy for v in results.values()) else 1


def cmd_gen_suite(args) -> int:
    from .testsuite import generate_suite

    path = generate_suite(
        args.out, args.suite, sfs=tuple(args.sfs), crs=tuple(args.crs),
        samp_rate=args.samp_rate, snr_db=args.snr, cfo_hz=args.cfo,
        drift_ppm=args.drift_ppm, sync_word=args.sync_word, seed=args.seed)
    print(path)
    return 0


def cmd_gateway(args) -> int:
    """Gateway receive: every channel x every SF of a wideband capture."""
    import torch

    from .config import LoRaConfig
    from .io.udp import MessageSocketSink

    if not os.path.exists(args.file):
        print(f"error: no such capture file: {args.file}", file=sys.stderr)
        return 2
    kw = {"plane_dtype": torch.bfloat16} if args.bf16 else {}
    if args.plan:
        # LoRaWAN regional plan: mixer-bank channelizer on the 200 kHz
        # raster (lora_tpu_torch.plans); frequencies are absolute
        from .plans import PlanGateway

        gw = PlanGateway(
            args.plan, args.center_freq, args.samp_rate,
            sfs=tuple(args.sfs), bandwidth=args.bandwidth, cr=args.cr,
            crc=args.crc, implicit=args.implicit,
            # class default 0x34 (public LoRaWAN) unless the user set one
            sync_word=0x34 if args.sync_word is None else args.sync_word,
            pool=args.pool, header_checksum=args.header_checksum,
            demod_method="fft", device=args.device, **kw)
    else:
        from .wideband import MultiSFWidebandReceiver

        M = args.channels
        cfg = LoRaConfig(
            sf=args.sfs[0], cr=args.cr, samp_rate=args.samp_rate / M,
            bandwidth=args.bandwidth, crc=args.crc, implicit=args.implicit,
            sync_word=0x00 if args.sync_word is None else args.sync_word)
        gw = MultiSFWidebandReceiver(
            cfg, M, sfs=args.sfs, pool=args.pool, demod_method="fft",
            header_checksum=args.header_checksum, device=args.device, **kw)
    if args.stream:
        # continuous mode: fixed-size overlap-save blocks with seam dedup,
        # the file read chunkwise: bounded memory for any capture length
        from .stream import WidebandStreamingReceiver, pump_file

        sr = WidebandStreamingReceiver(gw, block_symbols=args.block_symbols)
        frames = pump_file(sr, args.file)
    else:
        frames = gw.run(np.fromfile(args.file, dtype=np.complex64))
    sink = (MessageSocketSink(args.udp_ip, args.udp_port, args.layer)
            if args.udp else None)
    for f in frames:
        data = f.to_bytes(1)  # LORAPHY layer, like decode-file
        print(f"ch{f.channel} sf{f.tap_header.sf} {f.tap_header.frequency}Hz "
              + " ".join(f"{b:02x}" for b in data))
        if sink:
            sink.handle(f)
    if sink:
        sink.close()
    print(f"decoded {len(frames)} frames on "
          f"{len({f.channel for f in frames})} channels", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from .bench import cli_main

    return cli_main(["--dense-only", *([str(args.channels)] if args.channels else []),
                     *(["--device", args.device] if args.device else [])])


def cmd_timings(args) -> int:
    from .profiling import timing_table

    table = timing_table(tuple(args.sfs), tuple(args.methods), iters=args.iters,
                         device=args.device)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    return 0


def cmd_flowgraph(args) -> int:
    from .flowgraph import run_flowgraph

    frames = run_flowgraph(args.file, max_frames=args.max_frames,
                           max_seconds=args.max_seconds, device=args.device)
    print(f"decoded {len(frames)} frames", file=sys.stderr)
    return 0


def cmd_blocks(args) -> int:
    """The block descriptor set as YAML (grc/*.block.yml's fields)."""
    import yaml

    from .flowgraph import block_descriptors

    descs = block_descriptors()
    if args.block:
        descs = [d for d in descs if d["id"] in (args.block, f"lora_{args.block}")]
        if not descs:
            print(f"unknown block {args.block!r}", file=sys.stderr)
            return 2
    print(yaml.safe_dump_all(descs, sort_keys=False), end="")
    return 0


def cmd_analyze(args) -> int:
    from .debugger import live_analyze

    live_analyze(args.socket, max_buffers=args.max_buffers)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lora_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    device_help = "cuda (default: the card; raises without one) or cpu"

    d = sub.add_parser("decode-file", help="decode a capture file")
    d.add_argument("file")
    d.add_argument("--samp-rate", type=float, default=1e6)
    d.add_argument("--bandwidth", type=float, default=125e3)
    d.add_argument("--center-freq", type=float, default=868.1e6)
    d.add_argument("--offset", type=float, default=0.0)
    d.add_argument("--sf", type=int, default=7)
    d.add_argument("--cr", type=int, default=4)
    d.add_argument("--implicit", action="store_true")
    d.add_argument("--crc", action=argparse.BooleanOptionalAction, default=True,
                   help="payload carries a MAC CRC (--no-crc for raw cf32 "
                        "captures of crc-less frames)")
    d.add_argument("--reduced-rate", action="store_true")
    d.add_argument("--conj", action="store_true")
    d.add_argument("--decimation", type=int, default=1)
    d.add_argument("--no-drift-correction", action="store_true")
    d.add_argument("--engine", default="golden", choices=["golden", "parity", "dense"])
    d.add_argument("--low-snr", nargs="?", const=True, default=False,
                   type=_low_snr_value, metavar="auto",
                   help="coherent low-SNR mode (dense fft engine); '--low-snr "
                        "auto' tries the standard gates first and retries "
                        "empty captures coherently")
    d.add_argument("--udp", action="store_true")
    d.add_argument("--udp-ip", default="127.0.0.1")
    d.add_argument("--udp-port", type=int, default=40868)
    d.add_argument("--layer", type=int, default=2)
    d.add_argument("--device", default=None, help=device_help)
    d.set_defaults(fn=cmd_decode_file)

    t = sub.add_parser("testsuite", help="run SigMF test suites")
    t.add_argument("path")
    t.add_argument("suites", nargs="*")
    t.add_argument("--reports", default=None)
    t.add_argument("--engine", default="golden", choices=["golden", "parity", "dense"])
    t.add_argument("--nowrite", action="store_true")
    t.add_argument("--min-accuracy", type=float, default=0.0)
    t.add_argument("--device", default=None, help=device_help)
    t.set_defaults(fn=cmd_testsuite)

    g = sub.add_parser("gen-suite", help="generate a hermetic SigMF suite")
    g.add_argument("out")
    g.add_argument("--suite", default="short_sim")
    g.add_argument("--sfs", type=int, nargs="+", default=[7, 8, 9, 10, 11, 12])
    g.add_argument("--crs", type=int, nargs="+", default=[4, 3, 2, 1])
    g.add_argument("--samp-rate", type=float, default=1e6)
    g.add_argument("--snr", type=float, default=40.0)
    g.add_argument("--cfo", type=float, default=0.0)
    g.add_argument("--drift-ppm", type=float, default=0.0,
                   help="tx sample-clock offset (auto 30 for *drift* suites)")
    g.add_argument("--sync-word", type=lambda s: int(s, 0), default=0x00,
                   help="radio sync word (auto 0x12 for *sync12* suites)")
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_gen_suite)

    gw = sub.add_parser(
        "gateway",
        help="decode every channel x every SF of a raw cf32 wideband capture")
    gw.add_argument("file", help="raw complex64 wideband capture")
    gw.add_argument("--samp-rate", type=float, default=2e6,
                    help="wideband capture rate (channel rate = rate/channels)")
    gw.add_argument("--channels", type=int, default=8, help="PFB channel count")
    gw.add_argument("--plan", default=None,
                    help="LoRaWAN regional plan (EU868/US915/AU915) "
                         "instead of a PFB grid; needs --center-freq")
    gw.add_argument("--center-freq", type=float, default=868.3e6)
    gw.add_argument("--sfs", type=int, nargs="+", default=[7, 8, 9, 10, 11, 12])
    gw.add_argument("--cr", type=int, default=4)
    gw.add_argument("--bandwidth", type=float, default=125e3)
    gw.add_argument("--crc", action=argparse.BooleanOptionalAction, default=True)
    gw.add_argument("--implicit", action="store_true")
    gw.add_argument("--sync-word", type=lambda s: int(s, 0), default=None,
                    help="radio sync word (default 0x00; 0x34 in --plan "
                         "mode = public LoRaWAN)")
    gw.add_argument("--pool", type=int, default=16, help="per-SF global candidate pool")
    gw.add_argument("--bf16", action="store_true",
                    help="bfloat16 channel planes (halves their device traffic)")
    gw.add_argument("--header-checksum", action="store_true",
                    help="verify the PHY header checksum on rx")
    gw.add_argument("--stream", action="store_true",
                    help="continuous mode: overlap-save blocks + seam "
                         "dedup, bounded memory for long captures")
    gw.add_argument("--block-symbols", type=int, default=512,
                    help="--stream owned block length, in slowest-SF symbols")
    gw.add_argument("--udp", action="store_true")
    gw.add_argument("--udp-ip", default="127.0.0.1")
    gw.add_argument("--udp-port", type=int, default=40868)
    gw.add_argument("--layer", type=int, default=2)
    gw.add_argument("--device", default=None, help=device_help)
    gw.set_defaults(fn=cmd_gateway)

    b = sub.add_parser("bench", help="run the throughput benchmark (the dense stage)")
    b.add_argument("--channels", type=int, default=None)
    b.add_argument("--device", default=None, help=device_help)
    b.set_defaults(fn=cmd_bench)

    tm = sub.add_parser(
        "timings", help="per-stage timing study (parity with examples/lora-timings)")
    tm.add_argument("--sfs", type=int, nargs="+", default=[7, 12])
    tm.add_argument("--methods", nargs="+", default=["gradient", "fft"],
                    choices=["gradient", "fft"])
    tm.add_argument("--iters", type=int, default=5)
    tm.add_argument("--out", default=None, help="write the markdown table here")
    tm.add_argument("--device", default=None, help=device_help)
    tm.set_defaults(fn=cmd_timings)

    fg = sub.add_parser("flowgraph",
                        help="run a declarative flowgraph (parity with GRC .grc files)")
    fg.add_argument("file", help="flowgraph YAML")
    fg.add_argument("--max-frames", type=int, default=None)
    fg.add_argument("--max-seconds", type=float, default=None)
    fg.add_argument("--device", default=None, help=device_help)
    fg.set_defaults(fn=cmd_flowgraph)

    bl = sub.add_parser("blocks",
                        help="list flowgraph block descriptors (parity with grc/*.block.yml)")
    bl.add_argument("block", nargs="?", default=None)
    bl.set_defaults(fn=cmd_blocks)

    a = sub.add_parser("analyze", help="live sample scope (parity with grlora_analyze.py)")
    a.add_argument("--socket", default=DEFAULT_SOCK)
    a.add_argument("--max-buffers", type=int, default=None)
    a.set_defaults(fn=cmd_analyze)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
