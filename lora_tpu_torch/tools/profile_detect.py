"""Interleaved A/B timing of the detection metric's two kernels on the card.

    python -m lora_tpu_torch.tools.profile_detect [channels] [symbols]

``"pp"`` (K1, ``csrc/det_metrics.cu``: warps reduce rows straight from
device memory) against ``"tile"`` (K2, ``csrc/det_tile.cu``: blocks stage
``[2, T+1, W]`` slabs in shared memory), on float32 planes ``[C, 2, K1 *
1024]`` (default ``C = 16, K1 = 2048``: 268 MB). The two are first held
to each other (corr atol 2e-5, energies rtol 1e-5), then timed in
interleaved rounds: each round runs ``iters`` back-to-back calls of each
variant, ended by a ``torch.cuda.synchronize()`` barrier, and the best
round of each is kept, since a shared card's rate drifts between rounds.
Prints the card's name, each variant's ms and GB/s of planes read.
Raises without a card.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

SPS = 1024


def main(argv=None, iters: int = 20, rounds: int = 8) -> dict:
    """Run the study; returns ``{"ms": {variant: best ms}, "calls":
    {variant: kernel calls made}, "bytes": planes' bytes, "shape": ...}``."""
    from ..device import resolve_device
    from ..ops.cuda_kernels import detection_metrics_kernel

    argv = sys.argv[1:] if argv is None else argv
    C = int(argv[0]) if len(argv) > 0 else 16
    K1 = int(argv[1]) if len(argv) > 1 else 2048
    dev = resolve_device("cuda")
    print(f"profile_detect on {torch.cuda.get_device_name(dev)}")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(C, 2, K1 * SPS)).astype(np.float32)).to(dev)
    nbytes = x.numel() * x.element_size()
    print(f"input {list(x.shape)} float32, {nbytes / 1e6:.0f} MB")

    variants = ("tile", "pp")
    calls = dict.fromkeys(variants, 0)

    def run(v):
        calls[v] += 1
        return detection_metrics_kernel(x, SPS, variant=v)

    outs = {v: run(v) for v in variants}      # build + first launch, then the cross-check
    torch.cuda.synchronize(dev)
    err_c = float((outs["pp"][0] - outs["tile"][0]).abs().max())
    err_e = max(float(((a - b).abs() / b.abs()).max())
                for a, b in zip(outs["tile"][1:], outs["pp"][1:]))
    if err_c > 2e-5 or err_e > 1e-5:
        raise AssertionError(f"tile differs from pp: corr {err_c}, energies {err_e}")
    print(f"outputs match: corr max abs diff {err_c:.3g}, energy max rel diff {err_e:.3g}")
    del outs

    best = dict.fromkeys(variants, float("inf"))
    for _ in range(rounds):
        for v in variants:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                run(v)
            torch.cuda.synchronize(dev)
            best[v] = min(best[v], (time.perf_counter() - t0) / iters)
    for v, dt in best.items():
        print(f"{v}: best {dt * 1e3:.4f} ms  {nbytes / dt / 1e9:.0f} GB/s")
    return {"ms": {v: dt * 1e3 for v, dt in best.items()}, "calls": calls, "bytes": nbytes,
            "shape": list(x.shape)}


if __name__ == "__main__":
    main()
