"""The port's time-sharded wideband pipeline against lora_tpu's, on the
CPU: per-shard polyphase filterbank and decode with a right halo.

The input of tests/test_wideband_sharded.py: SF7 CR4/8 channels at 250
ksps, M = 8 at 2 Msps, one packet per shard block on rotating channels,
shard 2's straddling the seam into shard 3's block, noise 1e-4 a part.
JAX on ``make_mesh(8)`` over the virtual CPU devices, the port on
``make_mesh(devices=["cpu"] * 8)``. Each packet decodes exactly once;
``valid``, ``start``, ``length``, ``hdr`` and ``n_dropped`` bit-equal on
every lane, payloads on the valid lanes, ``snr`` rtol 1e-5 and ``cfo``
atol 1 Hz there."""

import numpy as np
import pytest

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.channelizer import pfb_channel_freqs
from lora_tpu.ops.xfer import pack_iq as jpack_iq
from lora_tpu.parallel import make_mesh as jmake_mesh
from lora_tpu.parallel import wideband_time_sharded_process as jwideband_time_sharded
from lora_tpu.tx.modulator import modulate_frame as jmodulate
from lora_tpu.wideband import WidebandReceiver as JWidebandReceiver

from lora_tpu_torch import LoRaConfig, WidebandReceiver
from lora_tpu_torch.parallel import make_mesh, wideband_time_sharded_process

from test_torch_sharding import assert_same

M = 8
CHAN_RATE = 250e3
N_DEV = 8
KW = dict(sf=7, cr=4, samp_rate=CHAN_RATE, crc=True)
RX = dict(max_candidates=2, max_symbols=16, sfd_search=12)


def capture(wr_pkt_samples, K, sps):
    """tests/test_wideband_sharded.py's capture: ``(x, block)``."""
    wide_rate = M * CHAN_RATE
    wide_cfg = JConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    sps_w = wide_cfg.samples_per_symbol
    blk = (wr_pkt_samples + K + 2) * M + 96 * sps_w
    blk = -(-blk // (M * sps)) * (M * sps)
    L = N_DEV * blk
    x = np.zeros(L, np.complex128)
    freqs = pfb_channel_freqs(wide_rate, M)
    rng = np.random.default_rng(0)
    for d in range(N_DEV):
        pkt = jmodulate(wide_cfg, bytes([d, 0xC3]), snr_db=None)
        pos = d * blk + 8 * sps_w
        if d == 2:
            pos = 3 * blk - len(pkt) // 3  # straddle the seam
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[d % M] / wide_rate * t)
    x += rng.normal(0, 1e-4, (L, 2)) @ [1, 1j]
    return x.astype(np.complex64), blk


@pytest.fixture(scope="module")
def receivers():
    jwr = JWidebandReceiver(JConfig(**KW), M, **RX)
    wr = WidebandReceiver(LoRaConfig(**KW), M, **RX, device="cpu")
    return jwr, wr


def decoded(res):
    valid = res.valid.cpu().numpy()
    pay = res.payload.cpu().numpy()
    return sorted((int(c), bytes(pay[d, c, k][:2])) for d, c, k in zip(*np.nonzero(valid)))


def test_wideband_time_sharded_matches_jax(receivers):
    jwr, wr = receivers
    x, blk = capture(wr.rx.pkt_samples, wr.pfb.K, wr.rx.sps)
    xf = jpack_iq(x)
    want = jax.device_get(jwideband_time_sharded(jwr, jmake_mesh(N_DEV))(xf))
    res = wideband_time_sharded_process(wr, make_mesh(devices=["cpu"] * N_DEV))(xf)
    assert tuple(res.valid.shape) == (N_DEV, M, wr.rx.P)
    assert tuple(res.n_dropped.shape) == (N_DEV, M)
    assert decoded(res) == sorted((d % M, bytes([d, 0xC3])) for d in range(N_DEV))
    assert int(res.start[res.valid].max()) < blk // M
    assert_same(res, want)


def test_wideband_time_sharded_halo_and_length(receivers):
    """An explicit channel-rate halo as JAX's; a length not divisible by
    ``n * M`` raises."""
    jwr, wr = receivers
    x, _ = capture(wr.rx.pkt_samples, wr.pfb.K, wr.rx.sps)
    xf = jpack_iq(x[: len(x) // 2])
    halo = wr.rx.pkt_samples + 2 * wr.rx.sps
    want = jax.device_get(jwideband_time_sharded(jwr, jmake_mesh(4),
                                                 halo_channel_samples=halo)(xf))
    fn = wideband_time_sharded_process(wr, make_mesh(devices=["cpu"] * 4),
                                       halo_channel_samples=halo)
    assert_same(fn(xf), want)
    with pytest.raises(ValueError):
        fn(xf[:, : 4 * M * 100 + 4])
