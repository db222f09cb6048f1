"""The port's sharding over ``torch.distributed``: 4 gloo ranks, one
shard each, on the CPU.

tests/multiproc_worker.py's checks, in the port's form: a stream with one
packet in each shard's block, time-sharded (the halo goes around the ring
by ``batch_isend_irecv``), decoded exactly once across the ranks (the
count summed over the group); and a subband-sharded capture whose packets
lie on bands owned by different ranks (the band exchange by
``all_to_all_single``). Each rank's result must be bit-equal to its shard
of the port's in-process 4-shard mesh, which tests/test_torch_sharding.py
and test_torch_subband_sharded.py hold to JAX.

The ranks are spawned from the test (``torch.multiprocessing.spawn``),
which imports this module in each of them: it imports neither JAX nor the
JAX package, and each rank checks that neither was loaded. The group is
set up through a file store in the test's temporary directory, so
parallel test workers cannot race for a port."""

import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lora_tpu_torch import DenseReceiver, LoRaConfig, WidebandReceiver
from lora_tpu_torch.ops.xfer import pack_iq
from lora_tpu_torch.parallel import (make_mesh, subband_channel_freq, time_sharded_process,
                                     wideband_subband_sharded_process)
from lora_tpu_torch.tx.modulator import modulate_frame

N_RANKS = 4
M_FINE = 8
CFG = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
PAYLOADS = [bytes([0xA0 | d, d, 0xFF ^ d]) for d in range(N_RANKS)]
# one packet on a band of each of two ranks
BAND_PLACEMENTS = [(1, 2, b"\x77"), (3, 3, b"\x99")]


def time_case():
    """``(receiver, packed stream)``: one packet in each shard's block of
    64 symbols."""
    rx = DenseReceiver(CFG, max_candidates=4, max_symbols=24, sfd_search=12, device="cpu")
    sps = CFG.samples_per_symbol
    block = 64 * sps
    stream = np.zeros(N_RANKS * block, np.complex64)
    for d, pl in enumerate(PAYLOADS):
        pkt = modulate_frame(CFG, pl, snr_db=40.0, seed=d)
        pos = d * block + (3 + d) * sps
        stream[pos:pos + len(pkt)] = pkt
    return rx, pack_iq(stream, device="cpu")


def subband_case():
    """``(wideband receiver, packed capture)`` of the two-stage
    channelizer over ``N_RANKS`` bands of ``M_FINE`` fine channels."""
    wr = WidebandReceiver(CFG, M_FINE, pool=8, max_candidates=2, max_symbols=12,
                          sfd_search=10, demod_method="fft", device="cpu")
    sps = CFG.samples_per_symbol
    wide_rate = N_RANKS * M_FINE * CFG.samp_rate
    chan_samples = (wr.rx.pkt_samples // sps + 16) * sps
    step = N_RANKS * N_RANKS * M_FINE
    L = -(-(N_RANKS * M_FINE * chan_samples) // step) * step
    wide_cfg = LoRaConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True, bandwidth=CFG.bandwidth)
    sps_w = wide_cfg.samples_per_symbol
    x = np.zeros(L, np.complex64)
    t = np.arange(L)
    for band, chan, pl in BAND_PLACEMENTS:
        f = subband_channel_freq(wide_rate, N_RANKS, M_FINE, band, chan)
        pkt = modulate_frame(wide_cfg, pl, snr_db=None)
        pos = 2 * sps_w * (1 + band)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * f / wide_rate
                                               * t[pos:pos + len(pkt)])).astype(np.complex64)
    return wr, pack_iq(x, device="cpu")


def _rank(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=N_RANKS)
    try:
        mesh = make_mesh(devices=["cpu"], group=dist.group.WORLD)
        rx, xf = time_case()
        res_t = time_sharded_process(rx, mesh)(xf)
        total = res_t.valid.sum(dtype=torch.int64)
        dist.all_reduce(total, group=mesh.group)
        wr, xw = subband_case()
        res_s = wideband_subband_sharded_process(wr, mesh)(xw)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lora_tpu"))
        torch.save({"rank": mesh.rank, "size": mesh.size, "time": res_t._asdict(),
                    "subband": res_s._asdict(), "total": int(total), "loaded": loaded},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _equal(got: dict, want, r: int) -> None:
    for f, v in want._asdict().items():
        assert torch.equal(got[f], v[r:r + 1]), (r, f)


def test_four_gloo_ranks_equal_the_in_process_mesh(tmp_path):
    ranks_run = mp.spawn(_rank, args=(str(tmp_path),), nprocs=N_RANKS, join=False)
    deadline = time.monotonic() + 300
    while not ranks_run.join(timeout=5):     # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ranks_run.processes:
                p.kill()
            pytest.fail("the ranks did not finish within 300 s")
    assert not any(p.is_alive() for p in ranks_run.processes)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(N_RANKS)]
    assert [(g["rank"], g["size"], g["loaded"]) for g in ranks] == \
        [(r, N_RANKS, []) for r in range(N_RANKS)]

    mesh = make_mesh(devices=["cpu"] * N_RANKS)
    rx, xf = time_case()
    want_t = time_sharded_process(rx, mesh)(xf)
    wr, xw = subband_case()
    want_s = wideband_subband_sharded_process(wr, mesh)(xw)
    for r, got in enumerate(ranks):
        _equal(got["time"], want_t, r)
        _equal(got["subband"], want_s, r)

    # every packet exactly once, in its own shard's block, with its payload
    assert all(g["total"] == N_RANKS for g in ranks)
    for r, got in enumerate(ranks):
        valid = got["time"]["valid"][0]
        assert int(valid.sum()) == 1, r
        k = int(valid.nonzero()[0, 0])
        n = int(got["time"]["length"][0, k])
        payload = bytes(got["time"]["payload"][0, k, :n].tolist())
        assert payload[:len(PAYLOADS[r])] == PAYLOADS[r], (r, payload.hex())
    # each placed band decodes its packet on its fine channel
    for band, chan, pl in BAND_PLACEMENTS:
        res = ranks[band]["subband"]
        hits = [g for g in res["valid"][0].nonzero()[:, 0].tolist()
                if int(res["channel"][0, g]) == chan
                and bytes(res["payload"][0, g, :len(pl)].tolist()) == pl]
        assert len(hits) == 1, (band, chan)


def test_world_size_one_group_equals_one_shard_mesh():
    """A gloo group of one rank, in this process: every transfer's two
    ends are the rank itself (local copies). Each function's result is
    bit-equal to the in-process one-shard mesh's, the channel-sharded one
    whole."""
    from lora_tpu_torch.parallel import channel_sharded_process, wideband_time_sharded_process

    rx, xf = time_case()
    wr, xw = subband_case()
    xc = xf[:, :4 * 4096].reshape(2, 4, 4096).transpose(0, 1).contiguous()
    fns = {"channel": (channel_sharded_process, rx, xc),
           "time": (time_sharded_process, rx, xf),
           "wideband time": (wideband_time_sharded_process, wr, xw),
           "subband": (wideband_subband_sharded_process, wr, xw)}
    one = make_mesh(devices=["cpu"])
    want = {k: make(obj, one)(x) for k, (make, obj, x) in fns.items()}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(devices=["cpu"], group=dist.group.WORLD)
        assert (mesh.size, mesh.rank) == (1, 0)
        for k, (make, obj, x) in fns.items():
            got = make(obj, mesh)(x)
            for f, v in want[k]._asdict().items():
                assert torch.equal(getattr(got, f), v), (k, f)
    finally:
        dist.destroy_process_group()
