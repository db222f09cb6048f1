"""What a kernel launch costs the host, beside what the cell's enqueue
costs a launch: the study behind ``dispatch.enqueue_ms``.

    python3 gwbench/launch_cost.py --workload us915_64ch.sparse --seed 5 --seconds 8

At one intra-op thread (the benchmark's) and at the machine's core count:

- ``bare_us``: host microseconds a call of ``torch.add(a, 1, out=b)`` on a
  1,024-element card tensor, over 20,000 calls (the card keeps up: it
  needs about 2 us a call);
- the cell, one traced run with a short window: ``enqueue_ms`` (the mean
  host time of a block's ``process_planes`` and result copies),
  ``launches`` (kernel launches a block, from the trace) and their
  quotient ``us_a_launch``.

One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CALLS = 20000


def bare_us() -> float:
    import torch

    a = torch.zeros(1024, device="cuda")
    b = torch.empty_like(a)
    for _ in range(1000):
        torch.add(a, 1, out=b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        torch.add(a, 1, out=b)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / CALLS * 1e6


def main(argv=None) -> int:
    from gwbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_mix(args.workload)
    for threads in (1, os.cpu_count() or 1):
        torch.set_num_threads(threads)
        out = run.run_cell(spec, args.seed, args.seconds, True, "cuda")
        enq = out["metrics"].get("dispatch.enqueue_ms", {}).get("value")
        launches = out["info"]["launches_per_block"]
        print(json.dumps(dict(threads=threads, bare_us=bare_us(), enqueue_ms=enq,
                              launches=launches, correct=out["correct"],
                              us_a_launch=enq * 1e3 / launches if enq and launches else None)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
