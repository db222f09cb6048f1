"""The port's two-stage subband-sharded wideband receive against
lora_tpu's, on the CPU: a coarse filterbank per time shard, the band
exchange, and a fine filterbank and pooled decode per band.

The input of tests/test_subband_sharded.py: SF7 CR4/5 fine channels at
250 ksps, M = 8 fine channels a band, 8 bands, packets on (band, fine
channel) (1, 2), (5, 3) and (6, 2), noise 1e-4 a part. JAX on
``make_mesh(8)`` over the virtual CPU devices, the port on
``make_mesh(devices=["cpu"] * 8)``. Held to: every placement decoded on
its band and channel; ``valid``, ``channel``, ``start``, ``length``,
``hdr`` and ``n_dropped`` bit-equal on every lane, payloads on the valid
lanes, ``cfo`` atol 1 Hz there, and ``snr`` rtol 2e-4 there.

The SNR's tolerance: a lane's SNR divides its packet window's energy by
that of a window of noise 1e-10 as strong, in a band whose coarse
filterbank output also carries the other bands' packets at the stopband
level. Float32 rounding of the coarse filterbank (the port's planes are
within 1.9e-7 of JAX's peak on this capture) moves that noise energy by
up to ~1e-4 of itself: JAX's own sharded run and JAX's coarse filterbank
in one call over the capture, followed by the same fine stage, give
5.7301105e9 and 5.729561e9 for the band-5 packet (9.6e-5 apart); given
JAX's band, the port's fine stage and decode give 5.7295616e9."""

import numpy as np
import pytest

import jax

from lora_tpu.config import LoRaConfig as JConfig
from lora_tpu.ops.xfer import pack_iq as jpack_iq
from lora_tpu.parallel import make_mesh as jmake_mesh
from lora_tpu.parallel import subband_channel_freq as jsubband_channel_freq
from lora_tpu.parallel import wideband_subband_sharded_process as jsubband_sharded
from lora_tpu.tx.modulator import modulate_frame as jmodulate
from lora_tpu.wideband import WidebandReceiver as JWidebandReceiver

from lora_tpu_torch import LoRaConfig, WidebandReceiver
from lora_tpu_torch.parallel import (make_mesh, subband_channel_freq,
                                     wideband_subband_sharded_process)

from test_torch_sharding import assert_same

N_DEV = 8
M_FINE = 8
KW = dict(sf=7, cr=1, samp_rate=250e3, crc=True)
RX = dict(max_candidates=2, max_symbols=12, sfd_search=10, demod_method="fft")
PLACEMENTS = [(1, 2, b"\x11"), (5, 3, b"\x22"), (6, 2, b"\x33")]


@pytest.fixture(scope="module")
def receivers():
    return (JWidebandReceiver(JConfig(**KW), M_FINE, pool=8, **RX),
            WidebandReceiver(LoRaConfig(**KW), M_FINE, pool=8, **RX, device="cpu"))


def capture(wr, n_dev=N_DEV, placements=PLACEMENTS):
    """tests/test_subband_sharded.py's capture (numpy complex64)."""
    cfg = JConfig(**KW)
    wide_rate = n_dev * M_FINE * cfg.samp_rate
    sps = cfg.samples_per_symbol
    chan_samples = 2 * wr.rx.pkt_samples // sps * sps + 16 * sps
    step = n_dev * n_dev * M_FINE
    L = -(-(n_dev * M_FINE * chan_samples) // step) * step
    wide_cfg = JConfig(sf=7, cr=1, samp_rate=wide_rate, crc=True, bandwidth=cfg.bandwidth)
    sps_w = wide_cfg.samples_per_symbol
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t_all = np.arange(L)
    for band, chan, payload in placements:
        f = jsubband_channel_freq(wide_rate, n_dev, M_FINE, band, chan)
        pkt = jmodulate(wide_cfg, payload, snr_db=None)
        pos = 2 * sps_w * (1 + band)
        x[pos:pos + len(pkt)] += (
            pkt * np.exp(2j * np.pi * f / wide_rate * t_all[pos:pos + len(pkt)])
        ).astype(np.complex64)
    return x


def decoded(res) -> dict:
    valid = res.valid.cpu().numpy()
    chan, pay = res.channel.cpu().numpy(), res.payload.cpu().numpy()
    plen = res.length.cpu().numpy()
    return {(int(d), int(chan[d, g])): bytes(pay[d, g][: plen[d, g]])
            for d, g in zip(*np.nonzero(valid))}


def test_subband_channel_freq_equals_jax():
    for band in range(N_DEV):
        for chan in (0, 3, 4, 7):
            assert subband_channel_freq(16e6, N_DEV, M_FINE, band, chan) == \
                jsubband_channel_freq(16e6, N_DEV, M_FINE, band, chan)


def test_subband_sharded_matches_jax(receivers):
    jwr, wr = receivers
    xf = jpack_iq(capture(wr))
    want = jax.device_get(jsubband_sharded(jwr, jmake_mesh(N_DEV))(xf))
    res = wideband_subband_sharded_process(wr, make_mesh(devices=["cpu"] * N_DEV))(xf)
    assert tuple(res.valid.shape) == (N_DEV, 8) and tuple(res.n_dropped.shape) == (N_DEV,)
    got = decoded(res)
    for band, chan, payload in PLACEMENTS:
        assert got[(band, chan)][: len(payload)] == payload, (band, chan, got)
    assert (res.n_dropped.numpy() >= 0).all()
    assert_same(res, want, lanes_with=("valid", "channel", "start", "length", "hdr"),
                snr_rtol=2e-4)


def test_subband_sharded_requires_pool():
    wr = WidebandReceiver(LoRaConfig(sf=7, cr=1, samp_rate=125e3, crc=True), 8,
                          max_candidates=2, max_symbols=12, sfd_search=8, device="cpu")
    with pytest.raises(ValueError):
        wideband_subband_sharded_process(wr, make_mesh(devices=["cpu"] * N_DEV))


def test_subband_sharded_length_not_whole_coarse_frames(receivers):
    _, wr = receivers
    fn = wideband_subband_sharded_process(wr, make_mesh(devices=["cpu"] * 4))
    with pytest.raises(ValueError):
        fn(np.zeros((2, 4 * 4 * M_FINE * 100 + 4 * M_FINE), np.float32))
