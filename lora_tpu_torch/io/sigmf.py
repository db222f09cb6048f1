"""SigMF trace reading/writing with the gr-lora metadata conventions.

The reference's test fixtures are SigMF recordings: raw ``cf32_le`` IQ in
``.sigmf-data`` plus JSON metadata in ``.sigmf-meta`` with custom ``lora:*``
config keys and ``test:expected`` / ``test:times`` ground truth
(reference apps/generate_test_suites.py:39-82,128-131 and
python/qa_testsuite.py:203-223). This module reads and writes that format
without external dependencies. The port's own copy of ``lora_tpu.io.sigmf``:
it writes the same bytes, so a suite generated by either package is the
same suite.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import LoRaConfig


@dataclass
class SigMFTrace:
    """One SigMF capture: samples + global/capture metadata."""

    samples: np.ndarray                    # complex64 IQ
    sample_rate: float
    capture_freq: float = 868e6            # core:frequency
    meta_global: dict = field(default_factory=dict)
    meta_capture: dict = field(default_factory=dict)

    # ---- gr-lora conventions -----------------------------------------

    @property
    def lora_config(self) -> LoRaConfig:
        """Build a LoRaConfig from the ``lora:*`` capture keys, mirroring
        qa_testsuite.py:206-231 (incl. the reduced-rate-for-SF>10 rule)."""
        cap = self.meta_capture
        sf = int(cap["lora:sf"])
        cr = cap["lora:cr"]
        cr_idx = int(str(cr).rpartition("/")[2]) - 4 if "/" in str(cr) else int(cr)
        return LoRaConfig(
            sf=sf,
            cr=cr_idx,
            bandwidth=float(cap.get("lora:bw", 125e3)),
            samp_rate=self.sample_rate,
            implicit=bool(cap.get("lora:implicit", False)),
            crc=bool(cap.get("lora:crc", True)),
            conj=bool(cap.get("lora:conj", False)),
            reduced_rate=sf > 10,
            prlen=int(cap.get("lora:prlen", 8)),
            sync_word=int(cap.get("lora:sync_word", 0)),
        )

    @property
    def frequency_offset(self) -> float:
        return float(self.meta_capture.get("lora:frequency_offset", 0.0))

    @property
    def expected(self) -> Optional[str]:
        return self.meta_capture.get("test:expected")

    @property
    def times(self) -> int:
        return int(self.meta_capture.get("test:times", 0))


def read_trace(meta_path: str) -> SigMFTrace:
    """Load a ``.sigmf-meta``/``.sigmf-data`` pair."""
    with open(meta_path) as f:
        meta = json.load(f)
    data_path = os.path.splitext(meta_path)[0] + ".sigmf-data"
    g = meta.get("global", {})
    caps = meta.get("captures", [{}])
    cap = dict(caps[0]) if caps else {}
    # gr-lora puts test/lora keys in the capture segment
    dtype = g.get("core:datatype", "cf32_le")
    if dtype not in ("cf32_le", "cf32"):
        raise ValueError(f"unsupported SigMF datatype {dtype}")
    samples = np.fromfile(data_path, dtype=np.complex64)
    return SigMFTrace(
        samples=samples,
        sample_rate=float(g.get("core:sample_rate", 1e6)),
        capture_freq=float(cap.get("core:frequency", 868e6)),
        meta_global=g,
        meta_capture=cap,
    )


def write_trace(
    path_stem: str,
    samples: np.ndarray,
    sample_rate: float,
    config: Optional[LoRaConfig] = None,
    capture_freq: float = 868.1e6,
    transmit_freq: Optional[float] = None,
    expected: Optional[str] = None,
    times: int = 0,
    extra_capture: Optional[dict] = None,
) -> str:
    """Write ``<stem>.sigmf-data`` + ``<stem>.sigmf-meta`` in the gr-lora
    test-suite layout (apps/generate_test_suites.py:68-82)."""
    samples = np.asarray(samples, dtype=np.complex64)
    samples.tofile(path_stem + ".sigmf-data")
    capture = {
        "core:sample_start": 0,
        "core:frequency": capture_freq,
    }
    if config is not None:
        capture.update(
            {
                "lora:frequency": transmit_freq if transmit_freq is not None else capture_freq,
                "lora:frequency_offset": (transmit_freq - capture_freq)
                if transmit_freq is not None else 0,
                "lora:sf": config.sf,
                "lora:cr": config.cr_string,
                "lora:bw": int(config.bandwidth),
                "lora:prlen": config.prlen,
                "lora:crc": config.crc,
                "lora:implicit": config.implicit,
                "lora:conj": config.conj,
                "lora:sync_word": config.sync_word,
            }
        )
    if expected is not None:
        capture["test:expected"] = expected
        capture["test:times"] = times
    if extra_capture:
        capture.update(extra_capture)
    meta = {
        "global": {
            "core:datatype": "cf32_le",
            "core:sample_rate": sample_rate,
            "core:version": "0.0.1",
            "core:recorder": "lora_tpu",   # the suites' recorder, either package
        },
        "captures": [capture],
        "annotations": [],
    }
    with open(path_stem + ".sigmf-meta", "w") as f:
        json.dump(meta, f, indent=2)
    return path_stem + ".sigmf-meta"


def list_suite(suite_dir: str) -> List[str]:
    """Metadata files of a suite, sorted by mtime (qa_testsuite.py:187)."""
    metas = [
        os.path.join(suite_dir, x)
        for x in os.listdir(suite_dir)
        if x.endswith(".sigmf-meta")
    ]
    return sorted(metas, key=os.path.getmtime)
