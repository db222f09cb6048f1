"""Implicit-header mode of the port's dense receiver against lora_tpu's.

Mirrors tests/test_implicit_dense.py on both engines: the fft engine's
energy stop on its static window grid (SF7 at 250 ksps, CR 4/5-4/8, and
SF6), the gradient engine's on its fine-sync-tracked windows (SF7 at
1 Msps). Each capture goes through the port and JAX's receiver: the
``DenseResult`` fields are held bit-equal for valid lanes (``valid``,
``start``, ``n_dropped``, ``payload``, ``length``, ``hdr``), ``snr`` to
rtol 1e-5 and ``cfo`` to 1 Hz (as tests/test_torch_dense.py), and the
frames to the ground truth: the payload starts with the sent bytes,
zero padding after."""

import numpy as np
import pytest

import jax

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame

from lora_tpu_torch import DenseReceiver, LoRaConfig

from test_torch_dense import assert_same

PAYLOAD = b"\xca\xfe\x01\x02"
RX = dict(max_candidates=2, max_symbols=24, sfd_search=12)


def _decode(kw, payload, snr_db, method):
    cfg = JConfig(**kw)
    sps = cfg.samples_per_symbol
    pkt = modulate_frame(cfg, payload, pad_before=4 * sps, pad_after=8 * sps, snr_db=snr_db)
    jrx = JDenseReceiver(cfg, demod_method=method, **RX)
    rx = DenseReceiver(LoRaConfig(**kw), demod_method=method, **RX, device="cpu")
    assert_same(rx.process(pkt), jax.device_get(jrx.process(pkt)), n_expected=1)
    frames = rx.run(pkt)
    want = jrx.run(pkt)
    assert len(frames) == len(want) == 1
    assert (frames[0].payload, frames[0].phy_header.to_bytes(), frames[0].sample_index) == \
        (want[0].payload, want[0].phy_header.to_bytes(), want[0].sample_index)
    return frames[0]


@pytest.mark.parametrize("cr", [4, 3, 2, 1])
def test_implicit_fft_matches_jax(cr):
    f = _decode(dict(sf=7, cr=cr, samp_rate=250e3, crc=False, implicit=True), PAYLOAD,
                40.0, "fft")
    assert f.payload[:len(PAYLOAD)] == PAYLOAD, f.payload.hex()
    # energy-stop length: padded up to whole interleave blocks, zeros after
    assert all(b == 0 for b in f.payload[len(PAYLOAD):])
    assert f.phy_header.cr == cr


def test_implicit_fft_sf6_matches_jax():
    f = _decode(dict(sf=6, cr=4, samp_rate=250e3, crc=False, implicit=True), b"\x42\x99",
                45.0, "fft")
    assert f.payload[:2] == b"\x42\x99"


@pytest.mark.parametrize("cr", [4, 1])
def test_implicit_gradient_matches_jax(cr):
    """The gradient engine's energy stop, a per-lane mask over every demod
    step (1 Msps: the gradient demod needs decim >= 4)."""
    f = _decode(dict(sf=7, cr=cr, samp_rate=1e6, crc=False, implicit=True), PAYLOAD,
                40.0, "gradient")
    assert f.payload[:len(PAYLOAD)] == PAYLOAD, f.payload.hex()
    assert all(b == 0 for b in f.payload[len(PAYLOAD):])


def test_implicit_two_packets_and_noise_lane_match_jax():
    """Two packets in one stream and a candidate lane on noise: the stop is
    read per lane, each lane's own."""
    kw = dict(sf=7, cr=2, samp_rate=250e3, crc=False, implicit=True)
    cfg = JConfig(**kw)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(4)
    a = modulate_frame(cfg, b"\x11\x22\x33", pad_before=3 * sps + 17, pad_after=5 * sps,
                       snr_db=35.0, seed=1)
    b = modulate_frame(cfg, bytes(range(9)), pad_before=2 * sps, pad_after=6 * sps,
                       snr_db=30.0, seed=2)
    x = np.concatenate([a, b]).astype(np.complex64)
    x = x + (0.002 * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))).astype(
        np.complex64)
    kwr = dict(RX, max_candidates=4)
    jrx = JDenseReceiver(cfg, demod_method="fft", **kwr)
    rx = DenseReceiver(LoRaConfig(**kw), demod_method="fft", **kwr, device="cpu")
    want = jax.device_get(jrx.process(x))
    assert_same(rx.process(x), want, n_expected=2)


def test_implicit_auto_routes_fft():
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=False, implicit=True)
    assert DenseReceiver(cfg, device="cpu").method == "fft"
    assert DenseReceiver(cfg.replace(samp_rate=1e6), device="cpu").method == "fft"
