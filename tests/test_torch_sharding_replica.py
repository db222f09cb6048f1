"""Sharding where a shard's device is not its receiver's: the replica
path of ``lora_tpu_torch.parallel``, on the CPU.

Devices compare with their index, so a receiver built on ``cpu:0`` is on
another device than the shards of ``make_mesh(devices=["cpu"] * 4)``:
each function then decodes with a replica built from the receiver's
``init_args``. Held to: the replica is a new receiver of the same kind
and arguments, and each of the four functions gives, field for field and
bit for bit, what the same mesh gives with a receiver built on ``cpu``.
The constructors' ``init_args`` cover every parameter but ``device``.

``sharding_cases`` and ``same_sharded`` are shared with
tests/test_torch_cuda.py, which holds the four functions on the card to
this mesh of CPU shards and runs a CPU receiver on a mesh of the card.
The file imports neither JAX nor the JAX package."""

import inspect

import numpy as np
import pytest
import torch

from lora_tpu_torch import DenseReceiver, LoRaConfig, WidebandReceiver
from lora_tpu_torch.channelizer import pfb_channel_freqs
from lora_tpu_torch.ops.xfer import pack_iq
from lora_tpu_torch.parallel import make_mesh
from lora_tpu_torch.parallel.sharding import _placed
from lora_tpu_torch.tx.modulator import modulate_frame

CASES = ["channel", "time", "wideband time", "subband"]


def sharding_cases(dev):
    """``{name: (make, receiver, input)}`` for the four sharded functions at
    tests/test_torch_sharding.py's, test_torch_wideband_sharded.py's and
    test_torch_subband_sharded.py's geometries (4 shards), the receivers
    on ``dev``."""
    from lora_tpu_torch.parallel import (channel_sharded_process, subband_channel_freq,
                                         time_sharded_process,
                                         wideband_subband_sharded_process,
                                         wideband_time_sharded_process)

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    rx = DenseReceiver(cfg, max_candidates=2, max_symbols=16, sfd_search=12, device=dev)
    pkt = modulate_frame(cfg, b"\xde\xad\xbe\xef", pad_before=600, pad_after=600, snr_db=40)
    two = np.pad(np.concatenate([pkt, pkt]), (0, rx.pkt_samples))
    chans = np.stack([np.roll(two, 31 * c) for c in range(8)]).astype(np.complex64)
    stream = np.concatenate([pkt] * 8).astype(np.complex64)
    stream = stream[: len(stream) // (4 * 256) * (4 * 256)]

    M, n = 8, 4
    wr = WidebandReceiver(cfg, M, pool=8, max_candidates=2, max_symbols=12, sfd_search=10,
                          demod_method="fft", device=dev)
    rng = np.random.default_rng(0)

    def capture(rate, L, placements):
        """Noise 1e-4 a part and a packet at each ``(position, frequency,
        payload)``, at ``rate``."""
        wcfg = LoRaConfig(sf=7, cr=4, samp_rate=rate, crc=True, bandwidth=cfg.bandwidth)
        x = rng.normal(0, 1e-4, (L, 2)) @ [1, 1j]
        for pos, f, pl in placements:
            p = modulate_frame(wcfg, pl, snr_db=None)
            t = np.arange(pos, pos + len(p))
            x[pos:pos + len(p)] += p * np.exp(2j * np.pi * f / rate * t)
        return pack_iq(x.astype(np.complex64), device="cpu")

    # wideband time: a packet in each shard's block on channel 2 * d, the
    # third across the seam into the last block
    rate = M * cfg.samp_rate
    blk = -(-(wr.rx.pkt_samples + wr.pfb.K + 2 + 64 * 256) * M // (M * 256)) * (M * 256)
    freqs = pfb_channel_freqs(rate, M)
    xt = capture(rate, n * blk, [(d * blk + (blk - 40000 if d == 2 else 8 * 2048),
                                  freqs[2 * d], bytes([0xC0 | d])) for d in range(n)])
    # subband: packets on bands 1, 2 and 3
    wide_rate = n * M * cfg.samp_rate
    step = n * n * M * 256
    L = -(-(n * M * (wr.rx.pkt_samples + 16 * 256)) // step) * step
    xs = capture(wide_rate, L, [(2 * 8192 * (1 + b), subband_channel_freq(wide_rate, n, M, b, c),
                                 pl) for b, c, pl in ((1, 2, b"\x11"), (3, 3, b"\x22"),
                                                      (2, 5, b"\x33"))])
    return {"channel": (channel_sharded_process, rx, pack_iq(chans, device="cpu")),
            "time": (time_sharded_process, rx, pack_iq(stream, device="cpu")),
            "wideband time": (wideband_time_sharded_process, wr, xt),
            "subband": (wideband_subband_sharded_process, wr, xs)}


def same_sharded(got, want, snr_rtol):
    """``got`` against ``want``: integers and valid payloads bit-equal,
    ``snr`` within ``snr_rtol`` and ``cfo`` within 1 Hz on the valid lanes."""
    valid = want.valid.cpu()
    for f in got._fields:
        g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if f == "payload":
            assert torch.equal(g[valid], w[valid])
        elif f == "snr":
            torch.testing.assert_close(g[valid], w[valid], rtol=snr_rtol, atol=0)
        elif f == "cfo":
            torch.testing.assert_close(g[valid], w[valid], rtol=0, atol=1.0)
        else:
            assert torch.equal(g, w), f


@pytest.fixture(scope="module")
def cases():
    """The four cases with receivers on ``cpu`` and on ``cpu:0``."""
    return {dev: sharding_cases(dev) for dev in ("cpu", "cpu:0")}


@pytest.mark.parametrize("case", CASES)
def test_replica_on_another_device_matches_native(cases, case):
    mesh = make_mesh(devices=["cpu"] * 4)
    make, native, x = cases["cpu"][case]
    _, home, _ = cases["cpu:0"][case]
    cpu = torch.device("cpu")
    assert home.device == torch.device("cpu", 0) != cpu
    placed = _placed(home, mesh)
    assert list(placed) == [cpu] and placed[cpu] is not home
    assert type(placed[cpu]) is type(home) and placed[cpu].init_args == home.init_args
    assert placed[cpu].device == cpu and _placed(native, mesh)[cpu] is native
    got, want = make(home, mesh)(x), make(native, mesh)(x)
    assert int(want.valid.sum()) > 0
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_init_args_cover_the_constructors():
    """Every constructor parameter but ``device`` reaches a replica; the
    dense keywords of a wideband receiver go through as given."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    rx = DenseReceiver(cfg, max_candidates=3, detect_threshold=0.8, device="cpu")
    assert set(rx.init_args) == set(inspect.signature(DenseReceiver).parameters) - {"device"}
    assert rx.init_args["max_candidates"] == 3 and rx.init_args["detect_threshold"] == 0.8
    wr = WidebandReceiver(cfg, 8, pool=4, max_candidates=3, sfd_search=10, device="cpu")
    own = set(inspect.signature(WidebandReceiver).parameters) - {"device", "dense_kwargs"}
    assert set(wr.init_args) == own | {"max_candidates", "sfd_search"}
    rep = WidebandReceiver(**wr.init_args, device="cpu")
    assert (rep.M, rep.pool, rep.rx.P, rep.rx.F) == (wr.M, wr.pool, wr.rx.P, wr.rx.F)
