"""Readings that set the limits of ``correct``: the program as the
configuration states it, and the control, the program's own path in the
nearest precision below the configuration's float32 (``plane_dtype``
bfloat16: the channel planes that detection and every SF's stage read,
cast to bfloat16). Both go through :func:`run.run_cell`, the harness's own
run and comparison, with a short window, on the same seeds in one process.

    python3 gwbench/control.py --workload us915_64ch.sparse_aligned --seeds 1,2,3 --seconds 4
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_spec(spec: dict) -> dict:
    """The cell with its planes in bfloat16."""
    return dict(spec, cfg=dict(spec["cfg"], plane_dtype="bfloat16"))


def readings(spec: dict, seed: int, device: str, seconds: float) -> dict:
    """``{"program": {...}, "control": {...}}``: ``correct`` and every
    number compared, of one run of each on ``seed``."""
    import torch

    from gwbench import run

    out = {}
    for side, s in (("program", spec), ("control", control_spec(spec))):
        r = run.run_cell(s, seed, seconds, False, device)
        out[side] = dict(correct=r["correct"], **{k: v["value"] for k, v in r["checks"].items()})
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    from gwbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    spec = run.load_mix(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(dict(seed=int(s), **readings(spec, int(s), "cuda", args.seconds))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
