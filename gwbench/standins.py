"""Decode failures of the cell's free-start traffic on other receiver
paths: short runs of the cell through :func:`run.run_cell`, many seeds, one
process. A variant overrides the configuration (channel rate, hop, the
receiver's options).

    python3 gwbench/standins.py --workload us915_64ch.sparse --variants 500k_fft,1M_fft \\
        --seeds 101,202,303 --seconds 2.5
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

VARIANTS = {
    "250k_fft": {},
    "250k_fft_drift": dict(receiver={"fft_drift_pass": True}),
    "500k_fft": dict(chan_rate=500e3, receiver={"demod_method": "fft"}),
    "500k_fft_drift": dict(chan_rate=500e3, receiver={"demod_method": "fft",
                                                      "fft_drift_pass": True}),
    "1M_fft": dict(chan_rate=1e6, hop_samples=1 << 28, receiver={"demod_method": "fft"}),
}


def main(argv=None) -> int:
    from gwbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variants", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("standins: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    base = run.load_mix(args.workload)
    for name in args.variants.split(","):
        spec = dict(base, cfg=dict(base["cfg"], **VARIANTS[name]))
        tot, lost_sf = Counter(), Counter()
        for s in (int(x) for x in args.seeds.split(",")):
            r = run.run_cell(spec, s, args.seconds, False, "cuda")
            lost = {(x["block"], x["channel"], x["sf"], x["grid"]) for x in r["info"]["lost"]}
            lost_sf.update(x[2] for x in lost)
            tot["runs"] += 1
            tot["uplinks"] += sum(r["info"]["uplinks_per_block"])
            tot["runs_not_correct"] += not r["correct"]
            print(json.dumps(dict(variant=name, seed=s, correct=r["correct"],
                                  checks={k: v["value"] for k, v in r["checks"].items()},
                                  lost=sorted(lost)[:8])), flush=True)
            torch.cuda.empty_cache()
        print(json.dumps(dict(variant=name, summary=dict(tot),
                              lost_by_sf={str(k): v for k, v in lost_sf.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
