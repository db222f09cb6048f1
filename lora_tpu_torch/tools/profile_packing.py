"""Layout study on the card: plane-major ``[C, 2, L]`` against window-major
``[C, K1, 2, sps]`` IQ for the detection metric.

    python -m lora_tpu_torch.tools.profile_packing [channels]

Times, on float32 noise of ``C`` channels (default 16) x 2048 windows of
1024 samples (268 MB):

a) K1 (``detection_metrics_kernel``) on the plane-major planes;
b) K6 (``detection_metrics_wm_kernel``) on the window-major copy, made on
   the card with ``permute(...).contiguous()`` outside the timing;
c) the plain torch version on the plane-major planes.

Each is the best of ``rounds`` rounds of ``iters`` back-to-back calls
ended by a ``torch.cuda.synchronize()`` barrier (a round is skipped once
the study has run ``budget`` seconds). K6's outputs are then held to
K1's on the first ``K = K1 - 1`` windows (corr atol 2e-5, energies rtol
1e-5). Prints the card's name, ms and GB/s of each. Raises without a
card.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

SPS = 1024
K1 = 2048


def timeit(fn, iters: int = 10, rounds: int = 5, budget: float = 60.0) -> float:
    """Best-of-rounds seconds a call of ``fn()``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    t_start = time.perf_counter()
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / iters)
        if time.perf_counter() - t_start > budget:
            break
    return best


def main(argv=None, iters: int = 10, rounds: int = 5) -> dict:
    """Run the study; returns ``{"ms": {"pp" | "wm" | "plain": best ms},
    "calls": {"pp" | "wm": kernel calls made}, "bytes": ..., "shape": ...}``."""
    from ..device import resolve_device
    from ..ops.cuda_kernels import (detection_metrics_kernel, detection_metrics_planes,
                                    detection_metrics_wm_kernel)

    argv = sys.argv[1:] if argv is None else argv
    C = int(argv[0]) if len(argv) > 0 else 16
    dev = resolve_device("cuda")
    print(f"profile_packing on {torch.cuda.get_device_name(dev)}")
    rng = np.random.default_rng(0)
    xd = torch.from_numpy(rng.normal(0, 1, (C, 2, K1 * SPS)).astype(np.float32)).to(dev)
    xw = xd.reshape(C, 2, K1, SPS).permute(0, 2, 1, 3).contiguous()
    gb = xd.numel() * xd.element_size() / 1e9
    calls = {"pp": 0, "wm": 0}

    def pp():
        calls["pp"] += 1
        return detection_metrics_kernel(xd, SPS)

    def wm():
        calls["wm"] += 1
        return detection_metrics_wm_kernel(xw)

    ms = {}
    for name, label, fn in (("pp", "pp    [C, 2, L]      ", pp),
                            ("wm", "wm    [C, K1, 2, sps]", wm),
                            ("plain", "plain [C, 2, L]      ",
                             lambda: detection_metrics_planes(xd, SPS))):
        dt = timeit(fn, iters, rounds)
        ms[name] = dt * 1e3
        print(f"{label}: {dt * 1e3:8.4f} ms  {gb / dt:7.1f} GB/s")

    c0, e1, e2 = pp()
    cw, ew = wm()
    K = K1 - 1
    err_c = float((cw[:, :K] - c0).abs().max())
    err_e = max(float(((ew[:, :K] - e1).abs() / e1.abs()).max()),
                float(((ew[:, 1:] - e2).abs() / e2.abs()).max()))
    if err_c > 2e-5 or err_e > 1e-5:
        raise AssertionError(f"wm differs from pp: corr {err_c}, energies {err_e}")
    print(f"match: corr max abs diff {err_c:.3g}, energy max rel diff {err_e:.3g}")
    return {"ms": ms, "calls": calls, "bytes": xd.numel() * xd.element_size(),
            "shape": list(xw.shape)}


if __name__ == "__main__":
    main()
