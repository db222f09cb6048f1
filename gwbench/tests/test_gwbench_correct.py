"""``correct``, driven end to end on the CPU at a size a test run holds:
the generator, the whole run with the chip's look skipped, the control,
and the timed path broken underneath in each way a cell can break.

The cell's configuration at a test size: SF7 only (the halo of one SF7
packet region), a hop of 2^20 wideband samples, two ring blocks of four
uplinks, the program's plain (CPU) paths. The fault "the exchange between
chips left out" does not apply: every cell runs on one chip.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gwbench import control, phy, run, traffic as gen  # noqa: E402

CELL = "us915_64ch.sparse_aligned"
FREE = "us915_64ch.sparse"     # the mix the stand-in stands in for, kept for a later cell
SEED = 2 ** 31 + 977


def small_spec():
    spec = run.load_cell(CELL)
    spec["cfg"] = dict(spec["cfg"], sfs=[7], hop_samples=1 << 20, ring_blocks=2)
    spec["traffic"] = dict(spec["traffic"], uplinks_per_s=61.0)   # 4 uplinks a block
    return spec


@pytest.mark.parametrize("mix", [CELL, FREE])
def test_schedule_is_the_seeds(mix):
    spec = run.load_mix(mix)
    cfg, tr = spec["cfg"], spec["traffic"]
    a, b = gen.schedule(cfg, tr, SEED, 3), gen.schedule(cfg, tr, SEED, 3)
    assert a == b
    c = gen.schedule(cfg, tr, SEED + 1, 3)
    assert c != a
    # every seed sends the same count at each SF
    count = lambda ups: sorted((u.sf for u in ups))
    assert count(a) == count(c) and len(a) == round(cfg["hop_samples"] / cfg["samp_rate"])


def test_aligned_starts_land_on_their_window_grid():
    """Every start of the stand-in is a window edge of its SF at the
    channel rate, inside the hop; the free mix's are not."""
    from gwbench import reference

    for mix, on_grid in ((CELL, True), (FREE, False)):
        spec = run.load_mix(mix)
        cfg, tr = spec["cfg"], spec["traffic"]
        geo = run.geometry(cfg)
        ups = [u for b in range(3) for u in gen.schedule(cfg, tr, SEED, b)]
        grid = [reference.chan_start(u, geo["K"], geo["D"]) % ((1 << u.sf) * 2) for u in ups]
        assert all(u.start < geo["hop"] for u in ups)
        assert all(g == 0 for g in grid) == on_grid


def test_aligned_mix_takes_distinct_channels_within_an_sf():
    spec = run.load_cell(CELL)
    cfg, tr = spec["cfg"], spec["traffic"]
    for b in range(4):
        ups = gen.schedule(cfg, tr, SEED, b)
        for sf in cfg["sfs"]:
            chans = [u.channel for u in ups if u.sf == sf]
            assert chans and len(set(chans)) == len(chans)


def test_blocks_are_the_seeds():
    """Bit for bit on one thread (CPU kernels split elementwise work by
    thread count, and their vector and scalar paths round apart; a CUDA
    kernel computes every element alike)."""
    spec = small_spec()
    cfg, tr = spec["cfg"], spec["traffic"]
    geo = run.geometry(cfg)
    ups = gen.schedule(cfg, tr, SEED, 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = gen.make_block(cfg, ups, geo["L"], SEED, 0, "cpu")
        y = gen.make_block(cfg, ups, geo["L"], SEED, 0, "cpu")
        z = gen.make_block(cfg, ups, geo["L"], SEED + 1, 0, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(x, y) and not torch.equal(x, z)


@pytest.mark.parametrize("sf", range(7, 13))
def test_largest_frame_fits_max_symbols_at_every_sf(sf):
    """The largest uplink the traffic sends at ``sf`` (SF11-12 too, for a
    plan that has them) fits the configuration's ``max_symbols``."""
    spec = run.load_cell(CELL)
    cfg, tr = spec["cfg"], spec["traffic"]
    n = tr["mac_overhead_bytes"] + gen.frm_cap(cfg, sf, tr) + phy.MAC_CRC_SIZE
    assert phy.payload_symbols(sf, cfg["cr"], n) <= cfg["max_symbols"]
    assert 2 * n <= phy.codeword_capacity(sf, cfg["max_symbols"])


def test_frozen_encoder_is_the_programs():
    from lora_tpu_torch.config import LoRaConfig
    from lora_tpu_torch.tx.modulator import encode_frame_symbols

    rng = np.random.default_rng(5)
    for sf in range(7, 13):
        for n in (14, 21, 29):
            p = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            want, _ = encode_frame_symbols(LoRaConfig(sf=sf, cr=1, samp_rate=250e3), p)
            assert np.array_equal(phy.frame_symbols(sf, 1, p), want)


def _run(patch=None):
    torch.manual_seed(0)
    return run.run_cell(small_spec(), SEED, 1.0, False, "cpu", patch=patch)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"gw_msps", "block_p95_ms", "setup_s"}


def _alter_answers(gw):
    """A payload byte altered where it is produced."""
    orig = gw.process_planes

    def process_planes(xf):
        res = orig(xf)
        return {sf: r._replace(payload=r.payload ^ 1) for sf, r in res.items()}
    gw.process_planes = process_planes


def _half_the_batch(gw):
    """Half of the channels left out of the planes every SF reads."""
    orig = gw.channel_planes

    def channel_planes(xf):
        cp = orig(xf).clone()
        cp[cp.shape[0] // 2:] = 0
        return cp
    gw.channel_planes = channel_planes


def _state_unchanged(gw):
    """A step that returns its first result for every later block."""
    orig, first = gw.process_planes, []

    def process_planes(xf):
        if not first:
            first.append(orig(xf))
        return first[0]
    gw.process_planes = process_planes


def _channelizer_off(gw):
    """The channelizer's output off by a part in a thousand."""
    orig = gw.channel_planes
    gw.channel_planes = lambda xf: orig(xf) * (1.0 + 1e-3)


@pytest.mark.parametrize("fault", [_alter_answers, _half_the_batch, _state_unchanged,
                                   _channelizer_off], ids=lambda f: f.__name__[1:])
def test_a_broken_timed_path_is_not_correct(fault):
    assert not _run(fault)["correct"]


def test_control_fails_and_program_passes_the_limit():
    """The program's own bfloat16 planes, through the harness's run and
    comparison, are not correct; the configuration's float32 is."""
    r = control.readings(small_spec(), SEED, "cpu", 1.0)
    limit = run._limits()["chan_err"]
    assert r["program"]["correct"] and r["program"]["chan_err"] < limit
    assert not r["control"]["correct"] and r["control"]["chan_err"] > limit


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """The cell at its size on the card: every number compared comes back,
    within its limit, and ``correct`` is their verdict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(run.load_cell(CELL), SEED, 2.0, False, "cuda")
    checks = out["checks"]
    assert set(checks) == {"missed", "wrong", "dropped", "chan_err"}
    assert out["correct"] == all(v["value"] <= v["limit"] for v in checks.values())
    assert out["correct"], checks
