"""The port's channel and time sharding against lora_tpu's, on the CPU.

The inputs of tests/test_sharding.py (SF7 CR4/8 at 250 ksps, a 40 dB
``deadbeef`` packet with 600 samples of padding each side), made the
same way. JAX runs on ``make_mesh(n)`` over the virtual CPU devices of
tests/conftest.py; the port on ``make_mesh(devices=["cpu"] * n)``, at n
= 8 and at n = 1 (the card's world size). Held to: ``valid``, ``start``,
``length``, ``hdr`` and ``n_dropped`` bit-equal on every lane, payloads
bit-equal on the valid lanes, ``snr`` rtol 1e-5 and ``cfo`` atol 1 Hz on
the valid lanes (energy sums and atan2 in another order)."""

import numpy as np
import pytest
import torch

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.ops.xfer import pack_iq as jpack_iq
from lora_tpu.parallel import channel_sharded_process as jchannel_sharded
from lora_tpu.parallel import make_mesh as jmake_mesh
from lora_tpu.parallel import time_sharded_process as jtime_sharded
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.parallel import (Mesh, channel_sharded_process, make_mesh,
                                     time_sharded_process)

DEADBEEF = bytes.fromhex("deadbeef")
KW = dict(sf=7, cr=4, samp_rate=250e3, crc=True)
RX = dict(max_candidates=2, max_symbols=16, sfd_search=12)


def assert_same(res, want, lanes_with=("valid", "start", "length", "hdr"), snr_rtol=1e-5):
    """Port result (tensors) against JAX's (numpy), as the module says;
    ``lanes_with``: the fields held bit-equal on every lane."""
    valid = np.asarray(want.valid)
    for f in lanes_with + ("n_dropped",):
        got, exp = getattr(res, f).cpu().numpy(), np.asarray(getattr(want, f))
        assert got.shape == exp.shape and got.dtype == exp.dtype, f
        np.testing.assert_array_equal(got, exp, err_msg=f)
    np.testing.assert_array_equal(res.payload.cpu().numpy()[valid],
                                  np.asarray(want.payload)[valid])
    np.testing.assert_allclose(res.snr.cpu().numpy()[valid], np.asarray(want.snr)[valid],
                               rtol=snr_rtol)
    np.testing.assert_allclose(res.cfo.cpu().numpy()[valid], np.asarray(want.cfo)[valid],
                               rtol=0, atol=1.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**KW)
    jrx = JDenseReceiver(jcfg, **RX)
    rx = DenseReceiver(LoRaConfig(**KW), **RX, device="cpu")
    pkt = jmodulate(jcfg, DEADBEEF, pad_before=600, pad_after=600, snr_db=40)
    return jcfg, jrx, rx, pkt


def test_mesh_of_cpu_shards():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"dev": 8} and mesh.group is None
    assert mesh.devices == (torch.device("cpu"),) * 8 and mesh.rank is None
    assert make_mesh(3, devices=["cpu"] * 8).size == 3
    assert make_mesh(axis="x", devices=["cpu"]).shape == {"x": 1}


def test_make_mesh_without_a_card_raises(monkeypatch):
    """No quiet CPU mesh: the default devices are the cards, and a CUDA
    device without a card raises, as the receivers' default does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 4)


def _channel_block(rx, pkt):
    stream = np.concatenate([pkt, pkt]).astype(np.complex64)
    stream = np.pad(stream, (0, rx.pkt_samples))
    return np.stack([np.roll(stream, 31 * c) for c in range(8)]).astype(np.complex64)


@pytest.mark.parametrize("n", [8, 1])
def test_channel_sharded_matches_jax(setup, n):
    jcfg, jrx, rx, pkt = setup
    x = _channel_block(rx, pkt)
    xf = jpack_iq(x)
    want = jax.device_get(jchannel_sharded(jrx, jmake_mesh(n))(xf))
    res = channel_sharded_process(rx, make_mesh(devices=["cpu"] * n))(xf)
    assert tuple(res.valid.shape) == (8, rx.P) and tuple(res.n_dropped.shape) == (8,)
    assert int(res.valid.sum()) == 16
    assert all(bytes(p[:4]) == DEADBEEF for p in res.payload[res.valid].numpy())
    assert_same(res, want)


def _stream(pkt, sps, n_pkts, n=8):
    stream = np.concatenate([pkt] * n_pkts).astype(np.complex64)
    block = (len(stream) // n // sps) * sps
    return stream[: block * n], block


@pytest.fixture(scope="module")
def one_shard_rx():
    """Receivers with lanes for all 12 packets of one shard."""
    rx = dict(RX, max_candidates=16)
    return JDenseReceiver(JConfig(**KW), **rx), DenseReceiver(LoRaConfig(**KW), **rx,
                                                              device="cpu")


@pytest.mark.parametrize("n", [8, 1])
def test_time_sharded_halo_matches_jax(setup, one_shard_rx, n):
    """12 packets over the shards; some straddle block seams and are
    claimed through the halo."""
    jcfg, jrx, rx, pkt = setup
    if n == 1:
        jrx, rx = one_shard_rx
    stream, block = _stream(pkt, jcfg.samples_per_symbol, 12)
    xf = jpack_iq(stream)
    want = jax.device_get(jtime_sharded(jrx, jmake_mesh(n))(xf))
    res = time_sharded_process(rx, make_mesh(devices=["cpu"] * n))(torch.from_numpy(xf))
    assert tuple(res.valid.shape) == (n, rx.P) and tuple(res.n_dropped.shape) == (n,)
    n_expected = sum(1 for k in range(12) if k * len(pkt) < block * 8 - len(pkt))
    assert int(res.valid.sum()) >= n_expected - 1
    assert all(bytes(p[:4]) == DEADBEEF for p in res.payload[res.valid].numpy())
    assert_same(res, want)


def test_no_double_claim_matches_jax(setup):
    """Each of 16 packets is decoded exactly once across 8 time shards."""
    jcfg, jrx, rx, pkt = setup
    stream, _ = _stream(pkt, jcfg.samples_per_symbol, 16)
    xf = jpack_iq(stream)
    want = jax.device_get(jtime_sharded(jrx, jmake_mesh(8))(xf))
    res = time_sharded_process(rx, make_mesh(devices=["cpu"] * 8))(xf)
    assert int(res.valid.sum()) == 16
    assert_same(res, want)


def test_halo_samples_and_axis(setup):
    """An explicit halo as JAX's; a mesh axis of another name; a time
    shard's ``start`` is block-relative."""
    jcfg, jrx, rx, pkt = setup
    stream, _ = _stream(pkt, jcfg.samples_per_symbol, 8, n=4)
    xf = jpack_iq(stream)
    halo = rx.pkt_samples + 3 * jcfg.samples_per_symbol
    want = jax.device_get(jtime_sharded(jrx, jmake_mesh(4, axis="t"), axis="t",
                                        halo_samples=halo)(xf))
    res = time_sharded_process(rx, make_mesh(devices=["cpu"] * 4, axis="t"), axis="t",
                               halo_samples=halo)(xf)
    assert_same(res, want)
    assert int(res.start[res.valid].max()) < stream.shape[0] // 4


@pytest.mark.parametrize("k,claims", [(2, 2), (6, 2), (8, 1)])
def test_preamble_across_a_seam_claimed_as_in_jax(setup, k, claims):
    """A fault of the reference, reproduced: a packet with only ``k`` of
    its preamble's symbols before a shard seam is claimed by the shard it
    starts in and, where the rest of its preamble still syncs (``k <=
    6``), again by the next shard at one window past the seam."""
    jcfg, jrx, rx, pkt = setup
    sps = jcfg.samples_per_symbol
    block = 64 * sps
    x = np.zeros(4 * block, np.complex64)
    p = jmodulate(jcfg, DEADBEEF, snr_db=40.0, seed=1)
    pos = 2 * block - k * sps + 37
    x[pos:pos + len(p)] = p
    xf = jpack_iq(x)
    want = jax.device_get(jtime_sharded(jrx, jmake_mesh(4))(xf))
    res = time_sharded_process(rx, make_mesh(devices=["cpu"] * 4))(xf)
    assert_same(res, want)
    assert res.valid.sum(dim=1).tolist() == [0, 1, claims - 1, 0]
    if claims == 2:
        assert int(res.start[2][res.valid[2]][0]) == sps


@pytest.mark.parametrize("case", ["channels", "length", "planes"])
def test_indivisible_inputs_raise(setup, case):
    jcfg, jrx, rx, pkt = setup
    mesh = make_mesh(devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        if case == "channels":
            channel_sharded_process(rx, mesh)(np.zeros((6, 2, 4096), np.float32))
        elif case == "length":
            time_sharded_process(rx, mesh)(np.zeros((2, 8 * 4096 + 4), np.float32))
        else:
            time_sharded_process(rx, mesh)(np.zeros((3, 2, 8 * 4096), np.float32))
