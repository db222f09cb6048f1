"""SigMF test-suite generation and evaluation.

The port's own copy of ``lora_tpu.testsuite``: the same generator (its
SigMF files are byte-equal to the JAX package's for the same arguments)
and a runner that builds the port's receiver facade on a torch device.
Hermetic replacement for the reference's over-the-air suite flow:

- :func:`generate_suite` — the offline analogue of
  ``apps/generate_test_suites.py``: synthesises SigMF traces with the tx
  modulator instead of driving an RN2483, using the same suite shapes
  (``short``: SF x CR x payloads {deadbeef x5, 88 x1, ffff x10};
  ``decode_long``: 255-byte payload at CR 4/8 — :157-200).
- :class:`TestSummary` / :func:`run_suite` — the evaluation harness of
  ``python/qa_testsuite.py``: per-trace flowgraph build, exact hex compare
  of MAC payloads, text + Markdown accuracy reports.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .config import LoRaConfig, MAC_CRC_SIZE
from .io.sigmf import SigMFTrace, list_suite, read_trace, write_trace
from .receiver import LoRaReceiver
from .tx.modulator import modulate_frame


def trunc(target: str, max_len: int = 30) -> str:
    if len(target) > max_len:
        return target[: max_len // 2 - 1] + ".." + target[-(max_len // 2) + 1 :]
    return target


class TestSummary:
    """Accuracy accounting + Markdown report (qa_testsuite.py:38-148)."""

    def __init__(self, suite: str, backend: Optional[str] = None):
        self.suite = suite
        now = datetime.datetime.now(datetime.timezone.utc)
        self.text = (
            f"-------- Test suite '{suite}' results on {now} ---------\n"
        )
        self.markdown = f"# Test suite: '{suite}'\n\n*Results on {now}*\n"
        if backend:
            # recorded provenance: the backend the suite ran on
            self.markdown += f"*Backend: {backend}*\n"
        self.total_correct = 0
        self.total = 0
        self.num_tests = 0
        self._last_config: Optional[str] = None

    def add(self, decoded: List[str], expected_payload: str, times: int,
            config_repr: str, print_intermediate: bool = True):
        self.num_tests += 1
        if self._last_config != config_repr:
            self.text += f"{config_repr}:\n"
            self.markdown += (
                f"\n### {config_repr}\n\nTransmitted payload | :heavy_check_mark: "
                "| :hash: | :heavy_division_sign:\n--- | --- | --- | ---\n"
            )
            self._last_config = config_repr
        correct = 0
        for i in range(times):
            self.total += 1
            got = decoded[i] if i < len(decoded) else "?"
            if got == expected_payload:
                correct += 1
                self.total_correct += 1
        line = (
            f"\tTest {self.num_tests:>3}: {trunc(expected_payload):<30} * {times:<3} :: "
            f"passed {correct:>3} out of {times:<3} ({correct / max(times, 1):.2%})\n"
        )
        self.text += line
        self.markdown += (
            f"`{trunc(expected_payload):<30}` | {correct:>3} | {times:>3} | "
            f"{correct / max(times, 1):>.2%}\n"
        )
        if print_intermediate:
            print(line, end="")

    def export(self, path: str, print_output: bool = True, write_output: bool = True) -> float:
        acc = self.total_correct / max(self.total, 1)
        self.text += (
            f"\nRan a total of {self.num_tests} tests, together containing "
            f"{self.total} payloads.\n"
            f"====== Total payloads passed: {self.total_correct:>5} out of "
            f"{self.total:<5}  ({acc:.2%}) ======\n"
        )
        self.markdown += (
            f"\n### Summary for suite '{self.suite}'\n\n"
            f"Total payloads passed: {self.total_correct} out of {self.total} "
            f"({acc:.2%})\n\n"
        )
        if print_output:
            print(self.text)
        if write_output:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, self.suite + ".md"), "w") as f:
                f.write(self.markdown)
        return acc


# ---------------------------------------------------------------------------


SHORT_PAYLOADS = [("deadbeef", 5), ("88", 1), ("ffff", 10)]


def apply_sdr_impairments(stream: np.ndarray, rng: np.random.Generator,
                          iq_imbalance_db: float = 35.0,
                          dc_offset: float = 0.01,
                          quantize_bits: int = 8,
                          full_scale: float = 4.0) -> np.ndarray:
    """Receiver-chain impairments of a cheap SDR front-end (rtl-sdr class).

    The reference's OTA fixtures were recorded with USRP/HackRF/RTL-SDR
    hardware whose captures carry, beyond CFO and clock drift, the
    front-end's IQ imbalance (finite image rejection: ``y = x + beta *
    conj(x)`` with ``|beta|`` at -``iq_imbalance_db``), a DC spike
    (zero-IF leakage, ``dc_offset`` relative to unit amplitude) and — for
    the RTL-SDR — 8-bit IQ quantization (cu8 format). Applying them to
    hermetic traces exercises the same signal degradations those captures
    would (reference ``apps/generate_test_suites.py`` hw list;
    ``docs/test-results/short_rtl-sdr.md``).
    """
    beta_mag = 10.0 ** (-iq_imbalance_db / 20.0)
    beta = beta_mag * np.exp(2j * np.pi * rng.uniform())
    y = stream + beta * np.conj(stream)
    y = y + dc_offset * np.exp(2j * np.pi * rng.uniform())
    if quantize_bits:
        # cu8-style midrise quantization over +-full_scale (headroom for
        # noise peaks; rtl-sdr AGC keeps signals well inside full scale)
        levels = float(1 << (quantize_bits - 1))
        scale = full_scale / levels
        y = (np.round(y.real / scale) + 1j * np.round(y.imag / scale)) * scale
    return y.astype(np.complex64)


def implicit_expected_hex(cfg: LoRaConfig, payload: bytes) -> str:
    """Decoded payload for an implicit-header (crc-less) frame: the
    transmitted bytes zero-padded to the interleave-block budget (the
    energy-stop decoder emits whole blocks; reference
    lib/decoder_impl.cc:842-847 block formula with no header codewords)."""
    ppm = cfg.sf - 2 if cfg.reduced_rate else cfg.sf
    hdr_slots = cfg.sf - 2          # first block is always reduced-rate
    needed = 2 * len(payload) - hdr_slots
    n_blocks = max(0, -(-needed // ppm))
    total_cw = hdr_slots + n_blocks * ppm
    return (payload + bytes(total_cw // 2 - len(payload))).hex()


def generate_suite(
    out_dir: str,
    suite: str = "short_sim",
    sfs: Sequence[int] = (7, 8, 9, 10, 11, 12),
    crs: Sequence[int] = (4, 3, 2, 1),
    samp_rate: float = 1e6,
    snr_db: float = 40.0,
    cfo_hz: float = 0.0,
    seed: int = 0,
    drift_ppm: float = 0.0,
    sync_word: int = 0x00,
) -> str:
    """Create a hermetic SigMF suite under ``out_dir/suite``.

    ``short*`` suites follow the reference matrix; ``decode_long*`` uses a
    single 255-byte payload (00..fe) at CR 4/8 per SF
    (apps/generate_test_suites.py:157-200).

    Suite-name modifiers extend past the reference's OTA matrix:
    ``*implicit*`` -> implicit-header frames (no PHY header, energy-stop
    end-of-frame, expected = block-padded payload); ``*conj*`` -> downlink
    (conjugated chirp) frames; ``*drift*`` -> transmitter sample-clock
    offset (``drift_ppm``, default 30 ppm — a typical crystal tolerance),
    applied by fractionally resampling each emitted packet. This is the
    impairment the reference's per-symbol fine-sync loop exists to track
    (lib/decoder_impl.cc:300-338): the receiver's symbol grid slides ~
    ``sps * ppm * 1e-6`` samples per symbol against the transmitter's.
    ``*sync12*`` -> frames carry the RN2483 sync word 0x12, as every one
    of the reference's OTA fixtures does (apps/generate_test_suites.py
    drives an RN2483).
    ``*sdr*`` -> full real-capture emulation: sync word 0x12, a per-trace
    transmitter crystal offset of up to ±10 ppm applied COHERENTLY to the
    carrier (CFO = ppm * 868.1 Hz) and the sample clock (drift), 20 dB
    SNR, plus the rx front-end impairments of
    :func:`apply_sdr_impairments` (IQ imbalance, DC offset, 8-bit
    quantization). This is the hermetic stand-in for the reference's OTA
    fixtures (which cannot be fetched in this environment): every
    impairment class its SDR captures carry is exercised at
    crystal-tolerance magnitudes.
    """
    suite_dir = os.path.join(out_dir, suite)
    os.makedirs(suite_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    implicit = "implicit" in suite
    conj = "conj" in suite and "implicit" not in suite
    # ``*alt*`` -> frames synthesised by the INDEPENDENT second
    # modulator (tx/altmod.py: phase-accumulator chirps, own encoder
    # loops, own impairment code) — the tx/rx de-correlation suite. A
    # correlated analog-convention bug between tx/modulator.py and the
    # receivers would fail here.
    alt = "alt" in suite
    if "drift" in suite and drift_ppm == 0.0:
        drift_ppm = 30.0
    sdr = "sdr" in suite
    if ("sync12" in suite or sdr) and sync_word == 0x00:
        sync_word = 0x12
    if sdr and snr_db >= 40.0:
        snr_db = 20.0
    idx = 0
    if suite.startswith("decode_long"):
        cases = [(sf, 4, bytes(range(255)).hex(), 1) for sf in sfs]
    else:
        cases = [
            (sf, cr, payload, times)
            for sf in sfs
            for cr in crs
            for payload, times in SHORT_PAYLOADS
        ]
    for sf, cr, payload_hex, times in cases:
        cfg = LoRaConfig(
            sf=sf, cr=cr, samp_rate=samp_rate, crc=not implicit,
            implicit=implicit, conj=conj, reduced_rate=sf > 10,
            sync_word=sync_word,
        )
        sps = cfg.samples_per_symbol
        payload = bytes.fromhex(payload_hex)
        # *sdr*: one tx crystal offset per trace, coherently coupling the
        # carrier (CFO) and the sample clock (drift) — they share the
        # crystal in real transmitters
        trace_cfo, trace_ppm = cfo_hz, drift_ppm
        if sdr:
            ppm = float(rng.uniform(-10.0, 10.0))
            trace_ppm = drift_ppm + ppm
            trace_cfo = cfo_hz + ppm * 868.1
        chunks = []
        for t in range(times):
            if alt:
                from .tx.altmod import modulate_frame_alt

                chunk = modulate_frame_alt(
                    cfg, payload,
                    pad_before=int(rng.integers(2000, 4000)),
                    pad_after=sps,
                    snr_db=snr_db, cfo_hz=trace_cfo,
                    drift_ppm=trace_ppm,  # altmod's own resampler
                    seed=int(rng.integers(0, 2**31)),
                )
            else:
                chunk = modulate_frame(
                    cfg, payload,
                    pad_before=int(rng.integers(2000, 4000)),
                    pad_after=sps,
                    snr_db=snr_db, cfo_hz=trace_cfo,
                    seed=int(rng.integers(0, 2**31)),
                )
                if trace_ppm:
                    from .channelizer import fractional_resampler

                    # receiver sampling a (1 + ppm)-fast transmitter
                    # clock: resample signal+noise by the clock ratio
                    chunk = fractional_resampler(
                        chunk, 1.0 + trace_ppm * 1e-6
                    ).astype(np.complex64)
            if sdr:
                chunk = apply_sdr_impairments(chunk, rng)
            chunks.append(chunk)
        chunks.append(np.zeros(3 * sps, np.complex64))
        stream = np.concatenate(chunks)
        stem = os.path.join(
            suite_dir, f"{idx:03d}-" + cfg.file_repr().replace("/", "_")
        )
        expected = (implicit_expected_hex(cfg, payload)
                    if implicit else payload_hex)
        write_trace(
            stem, stream, samp_rate, config=cfg,
            capture_freq=868.1e6, transmit_freq=868.1e6,
            expected=expected, times=times,
        )
        idx += 1
    return suite_dir


def run_suite(
    suites_path: str,
    suites_to_run: Sequence[str] = (),
    reports_path: Optional[str] = None,
    engine: str = "golden",
    write_output: bool = True,
    report_suffix: str = "",
    device=None,
) -> dict:
    """Evaluate every SigMF suite under ``suites_path``
    (qa_testsuite.py:176-247). Returns {suite: accuracy}.

    ``report_suffix`` is appended to report names (e.g. ``_dense`` gives
    ``short_sim_dense.md``) so per-engine accuracy matrices can coexist.
    ``device``: where the facades channelize and the dense engine decodes
    (``None``: the card); the report's backend stamp is its type
    (``numpy`` for the golden engine's decode).
    """
    from .device import resolve_device

    dev = resolve_device(device)
    if reports_path is None:
        reports_path = os.path.abspath(os.path.join(suites_path, "..", "test-results"))
    results = {}
    suites = [
        x for x in sorted(os.listdir(suites_path))
        if os.path.isdir(os.path.join(suites_path, x))
    ]
    # receivers cached per radio config: suites repeat each (sf, cr)
    # config across payload traces, and a fresh receiver instance would
    # rebuild its tables every trace
    rx_cache: dict = {}
    for suite in suites:
        if suites_to_run and suite not in suites_to_run:
            continue
        print(f"[+] Testing suite: '{suite}'")
        backend = "numpy" if engine == "golden" else dev.type
        summary = TestSummary(suite + report_suffix, backend=backend)
        for meta in list_suite(os.path.join(suites_path, suite)):
            print(f"[+] {meta}")
            trace = read_trace(meta)
            cfg = trace.lora_config
            # dense engine: payload-symbol capacity must cover the longest
            # expected frame (decode_long suites carry 255-byte payloads ~
            # 600 symbols at SF7 CR4/8 — far past the 48-symbol default);
            # bucket to multiples of 48 so short traces share one program
            n_expected = len(trace.expected or "") // 2
            need = cfg.payload_symbol_count(
                n_expected + (MAC_CRC_SIZE if cfg.crc else 0)
            )
            max_symbols = max(48, -(-need // 48) * 48)
            # The dense engine's explicit-mode receiver is CR-independent
            # (the coding rate is decoded from the PHY header; the
            # deinterleave tables cover all four CR variants behind one
            # gather), so one receiver serves every CR of an SF. Golden/parity keep per-CR
            # instances (their d_phdr initialises from constructor args,
            # reference lib/decoder_impl.cc:72-73).
            key_cr = 0 if (engine == "dense" and not cfg.implicit) else cfg.cr
            key = (trace.sample_rate, trace.capture_freq,
                   trace.frequency_offset, cfg.bandwidth, cfg.sf, key_cr,
                   cfg.implicit, cfg.crc, cfg.conj, cfg.reduced_rate,
                   max_symbols)
            rx = rx_cache.get(key)
            if rx is None:
                # dense engine: candidate capacity must cover every packet
                # in the trace (suite traces carry up to `times`=10)
                trace_engine = engine
                kw = ({"max_candidates": 16, "max_symbols": max_symbols}
                      if engine == "dense" else {})
                if cfg.implicit and engine == "dense":
                    # implicit dense reports are pinned to the fft engine
                    # (the throughput path and the auto-selection choice;
                    # the gradient engine's implicit mode is covered by
                    # tests/test_implicit_dense.py); golden/parity decode
                    # implicit with the reference's gradient method
                    kw["demod_method"] = "fft"
                rx = rx_cache[key] = LoRaReceiver(
                    samp_rate=trace.sample_rate,
                    center_freq=trace.capture_freq,
                    channel_list=[trace.capture_freq + trace.frequency_offset],
                    bandwidth=cfg.bandwidth,
                    sf=cfg.sf,
                    implicit=cfg.implicit,
                    cr=cfg.cr,
                    crc=cfg.crc,
                    reduced_rate=cfg.reduced_rate,
                    conj=cfg.conj,
                    engine=trace_engine,
                    device=dev,
                    **kw,
                )
            # bucket trace lengths (zero-pad up), as JAX's runner does to
            # reuse its compiled programs: the tail windows, and so the
            # decodes, are those of JAX's runs
            samples = trace.samples
            bucket = 64 * rx.config.samples_per_symbol * int(rx.decimation)
            pad = -len(samples) % bucket
            if pad:
                samples = np.concatenate(
                    [samples, np.zeros(pad, samples.dtype)]
                )
            frames = rx.receive(samples)
            decoded = [f.mac_payload.hex() for f in frames]
            summary.add(
                decoded, trace.expected, trace.times,
                cfg.string_repr(trace.capture_freq),
            )
        results[suite] = summary.export(reports_path, write_output=write_output)
    return results
