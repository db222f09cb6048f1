#!/usr/bin/env python3
"""The dense receiver's host pace in a fresh process, on one GPU.

    python3 tune/host_pace.py [--root DIR] [--then-gateway]

Imports ``chip_smoke.py`` and ``lora_tpu_torch`` from ``DIR`` (default:
this checkout; give an unpacked older commit to compare two trees in
one machine), builds that tree's kernels, decodes the dense bench block
(float32 and bf16 planes, the decode gate) and prints
``dense_rx_throughput`` as ``chip_smoke.py`` measures it, with the label
``isolated``. With ``--then-gateway`` (a tree that has the gateway), it
then drives the full-width gateway phase and measures the dense
throughput again in the same process (label ``after gateway``), which
shows whether the gateway's state slows the host's launches.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--then-gateway", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    print(f"tree: {Path(cs.__file__).resolve().parent}")
    name, smi = cs.phase_device()
    cs.phase_build()
    cfg, x, expected, _ = cs.bench_block()
    rx, planes, _ = cs.phase_main_path(cfg, x, expected)
    cs.phase_throughput("dense_rx_throughput", cs.dense_calls(rx, planes), "isolated",
                        name, smi)
    if args.then_gateway:
        gw, xd, _ = cs.phase_gateway()
        cs.phase_throughput("dense_rx_throughput", cs.dense_calls(rx, planes),
                            "after gateway", name, smi)
        del gw, xd
    return 0


if __name__ == "__main__":
    sys.exit(main())
