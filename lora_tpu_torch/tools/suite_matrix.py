"""The accuracy matrix on the port: generate each suite, run it, delete it.

    python -m lora_tpu_torch.tools.suite_matrix [SUITE ...] [--engine dense|parity|golden]
        [--reports DIR] [--work DIR] [--device cpu]

The suites are the 13 of the JAX package's accuracy matrix
(``docs/test-results/README.md``), generated with the parameters of
``tools/regen_reports.sh`` by the port's generator (byte-equal to JAX's)
into ``--work`` (default: ``.suites/`` in the repo root), one at a time,
each deleted once it has run: the whole matrix holds ~12 GB of traces,
one suite at most ~1.5 GB. Each runs through the port's ``run_suite``
(``engine``, ``device``: ``None`` is the card). With ``--reports`` each
suite's Markdown report goes there (``<suite>_<engine>.md``) with an
index (``README.md``; ``README_<engine>.md`` for an engine other than
dense) of every suite's counts and its generation and
decode seconds beside the device's name (and, on the card, its power
limit as ``nvidia-smi`` reads it). One JSON line a suite on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

# (suite, generate_suite arguments), as tools/regen_reports.sh makes them
MATRIX = (
    ("short_sim", {}),
    ("decode_long_sim", {}),
    ("short_sim_cfo500", {"cfo_hz": 500.0}),
    ("short_sim_conj", {}),
    ("short_sim_drift", {}),
    ("short_sim_drift10", {"drift_ppm": 10.0}),
    ("short_sim_implicit", {}),
    ("short_sim_sf13", {"sfs": (13,)}),
    ("short_sim_sf6_implicit", {"sfs": (6,)}),
    ("short_sim_snr10", {"snr_db": 10.0}),
    ("short_sim_sync12", {}),
    ("short_sim_sdr", {}),
    ("short_sim_alt", {}),
)
ROOT = Path(__file__).resolve().parents[2]


def device_line(device) -> str:
    """The device as a report names it: ``nvidia-smi``'s name and power
    limit on the card, ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run_one(suite: str, work: str, reports=None, engine: str = "dense", device=None,
            **gen_kw) -> dict:
    """Generate ``suite`` under ``work``, run it, delete it. Returns
    ``{suite, passed, total, accuracy, gen_s, decode_s}``."""
    from ..io.sigmf import list_suite, read_trace
    from ..testsuite import generate_suite, run_suite

    t0 = time.perf_counter()
    suite_dir = generate_suite(work, suite, **gen_kw)
    t1 = time.perf_counter()
    try:
        total = sum(read_trace(m).times for m in list_suite(suite_dir))
        acc = run_suite(work, (suite,), reports_path=reports, engine=engine,
                        write_output=reports is not None, report_suffix=f"_{engine}",
                        device=device)[suite]
    finally:
        shutil.rmtree(suite_dir)
    t2 = time.perf_counter()
    return dict(suite=suite, passed=round(acc * total), total=total, accuracy=acc,
                gen_s=round(t1 - t0, 3), decode_s=round(t2 - t1, 3))


def write_index(reports: str, rows, engine: str, device: str) -> str:
    """The index in ``reports``, one row a suite: ``README.md`` for the
    dense engine, ``README_<engine>.md`` for another, so the engines'
    reports share a directory."""
    lines = [
        "# Accuracy reports of the PyTorch/CUDA port",
        "",
        f"The {engine} engine of `lora_tpu_torch` on {device}, one report per suite",
        f"(`<suite>_{engine}.md`), written by `python -m lora_tpu_torch.tools.suite_matrix`.",
        "Each suite is generated by the port's generator with the parameters of",
        "`tools/regen_reports.sh`, run, and deleted; the seconds are this run's.",
        "",
        "| report | passed | total | accuracy | generate s | decode s |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        name = f"{r['suite']}_{engine}.md"
        lines.append(f"| [{name}]({name}) | {r['passed']} | {r['total']} | "
                     f"{100 * r['accuracy']:.2f}% | {r['gen_s']} | {r['decode_s']} |")
    path = os.path.join(reports, "README.md" if engine == "dense" else f"README_{engine}.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def run_matrix(suites=(), work=None, reports=None, engine: str = "dense", device=None):
    """Every suite of ``MATRIX`` (or those named) through :func:`run_one`;
    returns the rows, and writes the index when ``reports`` is given."""
    from ..device import resolve_device

    dev = resolve_device(device)
    work = str(ROOT / ".suites") if work is None else work
    os.makedirs(work, exist_ok=True)
    if reports is not None:
        os.makedirs(reports, exist_ok=True)
    rows = []
    for suite, kw in MATRIX:
        if suites and suite not in suites:
            continue
        rows.append(run_one(suite, work, reports, engine, dev, **kw))
        print(json.dumps(rows[-1]), flush=True)
    if reports is not None:
        write_index(reports, rows, engine, device_line(dev))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("suites", nargs="*", help="suites of the matrix to run (default: all)")
    p.add_argument("--engine", default="dense", choices=["golden", "parity", "dense"])
    p.add_argument("--reports", default=None)
    p.add_argument("--work", default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    rows = run_matrix(tuple(args.suites), args.work, args.reports, args.engine, args.device)
    return 0 if all(r["accuracy"] == 1.0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
