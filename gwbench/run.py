"""Benchmark of ``lora_tpu_torch``: whole-band LoRaWAN gateways decoded on
the card, blocks dispatched ahead.

    python3 gwbench/run.py --workload us915_64ch.sparse_aligned --seed 7 --seconds 10 --trace 0

A cell (``--workload``) is an entry of ``BENCHMARK.json``: a
configuration (``gwbench/configs/<config>.json``) under a traffic mix
(``gwbench/traffic/<traffic>.json``); a per-layer metric is read by
``gwbench/metrics/<name>.py``. Set-up builds the plan gateway, makes a
ring of capture blocks on the card from ``--seed`` and drives the whole
loop over ``in_flight + 1`` warm blocks. The window then replays the
ring for ``--seconds`` through ``PlanGateway.process_planes``, as the
program's streamer drives it: enqueue a block, copy every result field to
the host ``non_blocking``, record an event, and once more than
``in_flight`` blocks are queued wait for the oldest and build its frames
(``wideband._frames_from_pooled``, as ``PlanGateway.run`` does).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs
the same window, then profiles a few more blocks with spans around the
gateway's calls, and prints the per-layer metrics. Either way every
block's frames and a sample of the channel planes are held to the plain
reference (``reference.py``) once the window has closed, and the numbers
compared go last on standard error and last in the result line. The last
line of standard output is the result, a JSON object.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

# one process, few threads: the host's share of the loop is one thread
# launching kernels, and idle intra-op workers only contend with it
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import struct  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import namedtuple  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRACE_BLOCKS = 12          # blocks the profiler records in a --trace 1 run
SLICES_PER_BLOCK = 4       # channel-plane slices compared in each sampled block
SLICE_LEN = 8192           # channel-rate outputs a slice
SAMPLED_BLOCKS = 4         # window blocks whose channel planes are sampled
FORBIDDEN = ("jax", "jaxlib", "flax", "lora_tpu")
LIMITS_FILE = HERE / "limits.json"


def load_cell(name: str, root: Path = ROOT) -> dict:
    """``BENCHMARK.json``'s entry ``name`` with its configuration, traffic
    and per-layer metrics, read from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return dict(cell=cell, cfg=cfg, traffic=traffic, per_layer=per_layer,
                end_to_end=end_to_end)


def load_mix(name: str, root: Path = ROOT) -> dict:
    """A cell of ``BENCHMARK.json``, or any ``<config>.<traffic>`` pair of
    files that it does not list (the studies run mixes kept for later
    cells), without metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if any(w["name"] == name for w in bench["workloads"]):
        return load_cell(name, root)
    config, traffic = name.split(".", 1)
    return dict(cell=dict(name=name, config=config, traffic=traffic, chips=1),
                cfg=json.loads((HERE / "configs" / f"{config}.json").read_text()),
                traffic=json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
                per_layer=[], end_to_end=[])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``gwbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gwbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def geometry(cfg: dict) -> dict:
    """Block layout of a configuration: the channel filter's length, the
    decimation, the halo (``WidebandStreamingReceiver``'s: one packet
    region of the largest SF plus two of its symbols plus the filter's
    warm-up, at the channel rate, times the decimation) and the block."""
    from gwbench.reference import channel_taps

    K = len(channel_taps(cfg["samp_rate"], cfg["bandwidth"], cfg["chan_rate"]))
    D = int(round(cfg["samp_rate"] / cfg["chan_rate"]))
    sps_max = (1 << max(cfg["sfs"])) * int(round(cfg["chan_rate"] / cfg["bandwidth"]))
    pkt = (cfg["sfd_search"] + 13 + cfg["max_symbols"]) * sps_max
    halo = (pkt + 2 * sps_max + (-(-K // D) + 1)) * D
    hop = int(cfg["hop_samples"])
    L = hop + halo
    return dict(K=K, D=D, halo=halo, hop=hop, L=L, n_out=(L - K) // D + 1,
                C=len(cfg["channels_hz"]))


def build_gateway(cfg: dict, traffic: dict, device):
    import torch

    from lora_tpu_torch.plans import PlanGateway

    gw = PlanGateway(cfg["plan"], cfg["center_hz"], cfg["samp_rate"],
                     chan_rate=cfg["chan_rate"], sfs=tuple(cfg["sfs"]),
                     bandwidth=cfg["bandwidth"], cr=cfg["cr"], crc=cfg["crc"],
                     implicit=cfg["implicit"], sync_word=cfg["sync_word"],
                     pool=traffic.get("pool"),
                     plane_dtype={"float32": None, "bfloat16": torch.bfloat16}[cfg["plane_dtype"]],
                     fused=cfg["fused"], device=device, max_symbols=cfg["max_symbols"],
                     sfd_search=cfg["sfd_search"], **cfg.get("receiver", {}))
    if [round(f) for f in gw.channels] != [round(f) for f in cfg["channels_hz"]]:
        raise RuntimeError("the gateway's channels are not the configuration's")
    return gw


Decoded = namedtuple("Decoded", "channel sf sample_index payload")
_HEAD = struct.Struct("<HBq")


def _pack(f) -> bytes:
    """A frame as the bytes the check reads back: a long window keeps
    hundreds of thousands of them, and bytes are no work for the
    interpreter's garbage collector, which frame objects would be."""
    return _HEAD.pack(f.channel, f.tap_header.sf, f.sample_index) + f.payload


def _unpack(b: bytes) -> Decoded:
    c, sf, start = _HEAD.unpack_from(b)
    return Decoded(c, sf, start, b[_HEAD.size:])


def _fetch(res):
    """Every field of ``{sf: result}`` copied to the host ``non_blocking``
    (pinned memory from the card), as the program's streamer does."""
    return {sf: type(r)(*(t.to("cpu", non_blocking=True) for t in r)) for sf, r in res.items()}


class Loop:
    """The dispatch-ahead loop over the ring. ``drained`` holds a record
    a block: ``(ring index, enqueue start, enqueue end, result ready,
    frames done, frames (packed), n_dropped)``, host clock."""

    def __init__(self, gw, ring, in_flight: int, cuda: bool):
        import numpy as np

        from lora_tpu_torch.wideband import _frames_from_pooled

        self.gw, self.ring, self.in_flight, self.cuda = gw, ring, in_flight, cuda
        self.pending, self.drained = [], []
        self.n = 0
        self._frames_from_pooled = _frames_from_pooled
        self._idx = np.arange(len(gw.channels))
        self._zeros = np.zeros(len(gw.channels))

    def enqueue(self) -> None:
        import torch

        b = self.n % len(self.ring)
        t0 = time.perf_counter()
        res = _fetch(self.gw.process_planes(self.ring[b]))
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.pending.append((b, t0, time.perf_counter(), res, ev))
        self.n += 1

    def drain_one(self) -> None:
        b, t0, t1, res, ev = self.pending.pop(0)
        if ev is not None:
            ev.synchronize()
        t2 = time.perf_counter()
        frames = []
        for sf in self.gw.sfs:
            fs = self._frames_from_pooled(res[sf], self._idx, self.gw.rxs[sf].cfg, self._zeros)
            for f in fs:
                f.tap_header.frequency = int(self.gw.channels[f.channel])
                frames.append(_pack(f))
        dropped = {sf: int(res[sf].n_dropped) for sf in self.gw.sfs}
        self.drained.append((b, t0, t1, t2, time.perf_counter(), frames, dropped))

    def step(self) -> None:
        self.enqueue()
        while len(self.pending) > self.in_flight:
            self.drain_one()

    def run_for(self, seconds: float) -> tuple:
        """Drive until the first drain at or after ``seconds``; returns
        ``(start, end)`` of the window and the index of its first block
        in ``drained``."""
        first = len(self.drained)
        start = time.perf_counter()
        while True:
            self.step()
            if len(self.drained) > first and self.drained[-1][4] - start >= seconds:
                return start, self.drained[-1][4], first

    def run_blocks(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def finish(self) -> None:
        while self.pending:
            self.drain_one()


def slice_spots(rng, uplinks, geo) -> list:
    """Where a block's channel planes are compared: ``SLICES_PER_BLOCK``
    ``(channel, first output)`` pairs, every other one at an uplink of
    the block (its channel, from a quarter slice before its start), the
    rest anywhere."""
    limit = geo["n_out"] - SLICE_LEN
    spots = []
    for j in range(SLICES_PER_BLOCK):
        if j % 2 == 0 and uplinks:
            u = uplinks[int(rng.integers(len(uplinks)))]
            spots.append((u.channel, int(min(max(u.start // geo["D"] - SLICE_LEN // 4, 0),
                                             limit))))
        else:
            c = int(rng.integers(geo["C"]))
            spots.append((c, int(rng.integers(0, limit))))
    return spots


def _sampler(blocks, first: int, rng, geo, ring_uplinks):
    """Wrap the detection pass (``plans.multi_sf_detection_metrics``, the
    one module-level name ``plans`` looks up), whose first argument is the
    channel planes that every SF's stage reads, cast to the plane dtype:
    the calls numbered in ``blocks`` (the loop's count, ``first`` the
    next) keep copies of those planes at :func:`slice_spots`. Returns the
    copies and a function that removes the wrapper."""
    import lora_tpu_torch.plans as plans

    orig = plans.multi_sf_detection_metrics
    kept, count = [], [first]

    def multi_sf_detection_metrics(cp, *args, **kwargs):
        i = count[0]
        count[0] += 1
        if i in blocks:
            b = i % len(ring_uplinks)
            for c, t0 in slice_spots(rng, ring_uplinks[b], geo):
                kept.append((b, c, t0, cp[c, :, t0:t0 + SLICE_LEN].clone()))
        return orig(cp, *args, **kwargs)

    def remove():
        plans.multi_sf_detection_metrics = orig

    plans.multi_sf_detection_metrics = multi_sf_detection_metrics
    return kept, remove


def _spans(gw):
    """Install the profiler spans of a traced segment: around the
    gateway's instance methods and the one module-level name ``plans``
    looks up. Returns a function that removes them."""
    import torch

    import lora_tpu_torch.plans as plans

    def wrap(name, fn):
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner

    targets = [(gw, "process_planes", "gw.process_planes"),
               (gw, "channel_planes", "gw.channel_planes"),
               (plans, "multi_sf_detection_metrics", "gw.detect")]
    targets += [(rx, "process_pooled_planes", f"gw.phaseb.sf{sf}") for sf, rx in gw.rxs.items()]
    saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, wrap(name, getattr(obj, attr)))

    def remove():
        for obj, attr, old in saved:
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
    return remove


def end_to_end(records, hop: int, w_start: float, w_end: float) -> dict:
    """``gw_msps``: the owned samples (``hop``) of every block drained in
    the window over the window's seconds; ``block_p95_ms`` (and the
    median): a block's time from the start of its enqueue to its frames
    built, over every block drained in the window. ``records`` are
    :class:`Loop`'s ``drained`` entries of the window."""
    import numpy as np

    lat = [(r[4] - r[1]) * 1e3 for r in records]
    return {"gw_msps": len(records) * hop / (w_end - w_start) / 1e6,
            "block_p95_ms": float(np.percentile(lat, 95)) if lat else None,
            "block_p50_ms": float(np.percentile(lat, 50)) if lat else None}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _limits() -> dict:
    return json.loads(LIMITS_FILE.read_text())


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float = None, patch=None, trace_dir: str = None) -> dict:
    """One run of a cell; returns the result object. ``patch(gw)``, where
    given, is called on the gateway before set-up drives it (the tests'
    planted faults)."""
    import numpy as np
    import torch

    from gwbench import traffic as gen

    t_process = time.perf_counter() if t_process is None else t_process
    cfg, tr = spec["cfg"], spec["traffic"]
    cuda = device == "cuda"
    dev = torch.device(device)
    geo = geometry(cfg)
    marks = {"start": time.perf_counter() - t_process}
    gw = build_gateway(cfg, tr, dev)
    marks["gateway"] = time.perf_counter() - t_process
    if len(gw.taps) != geo["K"]:
        raise RuntimeError(f"the gateway's filter has {len(gw.taps)} taps, "
                           f"the configuration's {geo['K']}")
    if patch is not None:
        patch(gw)
    R = int(cfg["ring_blocks"])
    ring_uplinks = [gen.schedule(cfg, tr, seed, b) for b in range(R)]
    ring = [gen.make_block(cfg, ring_uplinks[b], geo["L"], seed, b, dev) for b in range(R)]
    if cuda:
        torch.cuda.synchronize()
    marks["ring"] = time.perf_counter() - t_process
    loop = Loop(gw, ring, int(cfg["in_flight"]), cuda)
    loop.run_blocks(loop.in_flight + 1)        # every shape, the drain and the frames, warm
    loop.finish()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks["warm"] = time.perf_counter() - t_process
    rng = np.random.default_rng(gen.block_seed(seed, 0, 2))
    span = max(2 * R, SAMPLED_BLOCKS)
    sampled = set(int(i) for i in rng.choice(np.arange(loop.n, loop.n + span),
                                             size=SAMPLED_BLOCKS, replace=False))
    kept, unsample = _sampler(sampled, loop.n, rng, geo, ring_uplinks)
    setup_s = time.perf_counter() - t_process
    w_start, w_end, first = loop.run_for(seconds)
    in_window = loop.drained[first:]
    loop.finish()
    unsample()
    trace_out = _traced_segment(gw, loop, trace_dir) if trace else None
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    power = _power_limit() if cuda else "cpu"
    # the program's state goes before the reference runs
    hosts = [(b, frames, dropped) for b, _, _, _, _, frames, dropped in loop.drained]
    e2e = end_to_end(in_window, geo["hop"], w_start, w_end)
    enq_ms = [(r[2] - r[1]) * 1e3 for r in in_window]
    frames_ms = [(r[4] - r[3]) * 1e3 for r in in_window]
    n_window = len(in_window)
    del loop, gw
    if cuda:
        torch.cuda.empty_cache()
    checks = _check(cfg, geo, hosts, ring, ring_uplinks, kept)
    lim = _limits()
    correct = (checks["missed"] <= lim["frames_missed"] and checks["wrong"] <= lim["frames_wrong"]
               and checks["dropped"] <= lim["n_dropped"] and checks["chan_err"] <= lim["chan_err"]
               and checks["slices"] > 0)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    ctx = dict(geo=geo, cfg=cfg, traffic=tr, blocks=n_window, enq_ms=enq_ms,
               frames_ms=frames_ms, window_s=w_end - w_start, trace=trace_out,
               power_limit=power)
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if trace_out:
            device_info["busy_s"] = trace_out["busy_s"]
            device_info["window_s"] = trace_out["window_s"]
    else:
        e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted = sum(len(ring_uplinks[b]) for b, _, _ in hosts)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": checks["missed"] + checks["wrong"], "metrics": metrics,
           "device": device_info}
    if trace and trace_out:
        out["breakdown"] = {"device_ops": trace_out["device_ops"],
                            "idle_gaps": trace_out["idle_gaps"]}
    out["info"] = {"blocks_in_window": n_window, "blocks_drained": len(hosts),
                   "window_s": w_end - w_start, "block_p50_ms": e2e["block_p50_ms"],
                   "block_max_ms": max(((r[4] - r[1]) * 1e3 for r in in_window), default=None),
                   "enqueue_max_ms": max(enq_ms, default=None),
                   "uplinks_per_block": [len(u) for u in ring_uplinks],
                   "card": power, "seed": seed, "start_sym_max": checks["start_sym"],
                   "setup_marks_s": marks,
                   "launches_per_block": (trace_out["launches"] / trace_out["blocks"]
                                          if trace_out else None),
                   "lost": checks["lost"][:24], "bad": checks["bad"][:24]}
    out["checks"] = {k: {"value": checks[k], "limit": lim[v]} for k, v in
                     (("missed", "frames_missed"), ("wrong", "frames_wrong"),
                      ("dropped", "n_dropped"), ("chan_err", "chan_err"))}
    return out


def _traced_segment(gw, loop, trace_dir):
    """Profile ``TRACE_BLOCKS`` more blocks with the spans installed, and
    reduce the trace."""
    import torch

    from gwbench import trace

    loop.finish()
    remove = _spans(gw)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(trace_dir or os.environ.get("TMPDIR", "/tmp"),
                        f"gwbench_trace_{os.getpid()}.json")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("gwbench.window"):
                loop.run_blocks(TRACE_BLOCKS)
                loop.finish()
        prof.export_chrome_trace(path)
        out = trace.reduce(path, "gwbench.window")
        if out:
            out["blocks"] = TRACE_BLOCKS
        return out or None
    finally:
        remove()
        if os.path.exists(path):
            os.remove(path)


def _check(cfg, geo, hosts, ring, ring_uplinks, kept) -> dict:
    """Every drained block's frames against its uplinks, and the sampled
    channel-plane slices against the reference."""
    from gwbench import reference

    missed = wrong = dropped = 0
    start_sym = 0.0
    lost, bad = {}, []
    for b, frames, drop in hosts:
        c = reference.compare_frames([_unpack(f) for f in frames], ring_uplinks[b], cfg,
                                     geo["K"], geo["D"])
        for u in c["lost"]:
            lost[(b, u.channel, u.start)] = u
        bad += [dict(x, block=b) for x in c["bad"]]
        missed += c["missed"]
        wrong += c["wrong"]
        start_sym = max(start_sym, c["start_sym"])
        dropped = max(dropped, max(drop.values()))
    taps = reference.channel_taps(cfg["samp_rate"], cfg["bandwidth"], cfg["chan_rate"])
    err = 0.0
    for b, c, t0, got in kept:
        ref = reference.channel_slice(ring[b], cfg["channels_hz"][c] - cfg["center_hz"],
                                      cfg["samp_rate"], taps, geo["D"], t0, got.shape[-1])
        err = max(err, reference.slice_error(got.to(ref.device), ref))
    os_ = int(round(cfg["chan_rate"] / cfg["bandwidth"]))
    lost = [dict(block=b, sf=u.sf, channel=u.channel, snr_db=round(u.snr_db, 2),
                 drift_ppm=round(u.drift_ppm, 2), bytes=len(u.phy),
                 grid=round(reference.chan_start(u, geo["K"], geo["D"]) % ((1 << u.sf) * os_), 3))
            for (b, _, _), u in sorted(lost.items())]
    return {"missed": missed, "wrong": wrong, "dropped": dropped, "chan_err": err,
            "slices": len(kept), "start_sym": start_sym, "lost": lost, "bad": bad}


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (the whole name, so ``lora_tpu_torch`` is not
    ``lora_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".gwbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    spec = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gwbench: the cell needs {need} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"gwbench: the process loaded {bad}: no result", file=sys.stderr)
        return 3
    for x in out["info"]["lost"][:8]:
        print(f"lost: ring block {x['block']}, SF{x['sf']}, channel {x['channel']}, "
              f"{x['snr_db']} dB, {x['grid']} channel samples past its SF's window grid",
              file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
