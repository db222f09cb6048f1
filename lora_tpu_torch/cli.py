"""Command line of the PyTorch/CUDA port.

    python -m lora_tpu_torch.cli timings [--sfs 7 12] [--methods gradient fft]
                                         [--iters 5] [--out FILE] [--device cpu]

``timings`` prints the per-stage timing study
(:func:`lora_tpu_torch.profiling.timing_table`) on the card, or on the CPU
with ``--device cpu``. Only this subcommand is ported so far.
"""

from __future__ import annotations

import argparse
import sys


def cmd_timings(args) -> int:
    from .profiling import timing_table

    table = timing_table(tuple(args.sfs), tuple(args.methods), iters=args.iters,
                         device=args.device)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lora_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    tm = sub.add_parser(
        "timings", help="per-stage timing study (parity with examples/lora-timings)")
    tm.add_argument("--sfs", type=int, nargs="+", default=[7, 12])
    tm.add_argument("--methods", nargs="+", default=["gradient", "fft"],
                    choices=["gradient", "fft"])
    tm.add_argument("--iters", type=int, default=5)
    tm.add_argument("--out", default=None, help="write the markdown table here")
    tm.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or cpu")
    tm.set_defaults(fn=cmd_timings)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
