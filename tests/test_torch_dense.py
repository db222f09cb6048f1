"""The port's dense receiver (fft engine) against lora_tpu's, end to end.

SF7 CR4/8 at 250 ksps, 3 channels x 480 symbols, packets at assorted
offsets, CFOs and sync words over a low noise floor. The port runs on the
CPU, once with its own tables and once with the tables of the JAX
receiver installed by ``load_tables`` (its arithmetic apart from its
table building). Held to: equal ``valid`` masks and candidate starts;
for valid lanes bit-equal ``payload``, ``length``, ``hdr``; ``snr`` rtol
1e-5 (energy sums in another order); ``cfo`` atol 1 Hz (~0.1 % of a bin:
atan2 and sum-order rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.convert import load_tables
from lora_tpu_torch.ops.xfer import pack_iq, unpack_iq

from test_torch_ops import jax_tables

KW = dict(sf=7, cr=4, samp_rate=250e3, crc=True)
RX = dict(max_candidates=4, max_symbols=40, sfd_search=12)
# (channel, symbol offset, extra samples, payload, cfo Hz, sync word)
PACKETS = [
    (0, 5, 37, b"\xde\xad\xbe\xef", 0.0, 0x00),
    (0, 190, 101, b"hello lora", -230.0, 0x34),
    (1, 60, 3, bytes(range(14)), 310.0, 0x12),
    (2, 12, 200, b"\x00", 120.0, 0x00),
    (2, 300, 0, b"\xa5" * 6, -90.0, 0x34),
]


def make_block(kw, n_sym=480, seed=7):
    cfg = JConfig(**kw)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(seed)
    x = 0.003 * (rng.normal(size=(3, n_sym * sps))
                 + 1j * rng.normal(size=(3, n_sym * sps)))
    x = x.astype(np.complex64)
    for c, sym, extra, payload, cfo, sw in PACKETS:
        pkt = jmodulate(cfg.replace(sync_word=sw), payload, cfo_hz=cfo,
                        snr_db=30.0, seed=sym)
        s0 = sym * sps + extra
        x[c, s0:s0 + len(pkt)] += pkt
    return x


@pytest.fixture(scope="module")
def block():
    return make_block(KW)


@pytest.fixture(scope="module")
def jrx():
    return JDenseReceiver(JConfig(**KW), **RX)


@pytest.fixture(scope="module")
def jres(jrx, block):
    return jax.device_get(jrx.process(block))


def port_rx(jrx=None, kw=KW, **extra):
    rx = DenseReceiver(LoRaConfig(**kw), **RX, **extra, device="cpu")
    if jrx is not None:
        load_tables(rx, jax_tables(jrx))
    return rx


def assert_same(res, want, n_expected=None):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(res.valid.cpu().numpy(), valid)
    if n_expected is not None:
        assert valid.sum() == n_expected
    np.testing.assert_array_equal(res.start.cpu().numpy(), np.asarray(want.start))
    np.testing.assert_array_equal(res.n_dropped.cpu().numpy(), np.asarray(want.n_dropped))
    for f in ("payload", "length", "hdr"):
        got = getattr(res, f).cpu().numpy()
        exp = np.asarray(getattr(want, f))
        assert got.dtype == exp.dtype, f
        np.testing.assert_array_equal(got[valid], exp[valid], err_msg=f)
    np.testing.assert_allclose(res.snr.cpu().numpy()[valid], np.asarray(want.snr)[valid],
                               rtol=1e-5)
    np.testing.assert_allclose(res.cfo.cpu().numpy()[valid], np.asarray(want.cfo)[valid],
                               rtol=0, atol=1.0)


@pytest.mark.parametrize("tables", ["own", "loaded"])
def test_process_matches_jax(block, jrx, jres, tables):
    rx = port_rx(jrx if tables == "loaded" else None)
    assert_same(rx.process(block), jres, n_expected=len(PACKETS))


def test_run_frames_match_jax(block, jrx):
    want = jrx.run(block, channel_offset=3)
    got = port_rx().run(block, channel_offset=3)
    assert len(got) == len(want) == len(PACKETS)
    for g, w in zip(got, want):
        assert g.phy_header.to_bytes() == w.phy_header.to_bytes()
        assert (g.payload, g.channel, g.sample_index) == (w.payload, w.channel,
                                                          w.sample_index)
        assert g.crc_ok is True and w.crc_ok is True
        assert g.snr == pytest.approx(w.snr, rel=1e-5)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)
        assert g.tap_header.to_bytes() == w.tap_header.to_bytes()


def test_bf16_planes_match_jax(block, jrx):
    rx = port_rx()
    pad = np.pad(block, [(0, 0), (0, rx.pkt_samples)])
    xt = pack_iq(pad, dtype=torch.bfloat16, device="cpu")
    assert xt.dtype == torch.bfloat16 and xt.shape == (3, 2, pad.shape[-1])
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)  # same values
    assert_same(rx.process(xt), jax.device_get(jrx.process(xj)),
                n_expected=len(PACKETS))


def test_conj_config_matches_jax():
    kw = dict(KW, conj=True)
    x = make_block(kw, seed=11)
    jrx = JDenseReceiver(JConfig(**kw), **RX)
    want = jax.device_get(jrx.process(x))
    assert_same(port_rx(kw=kw).process(x), want, n_expected=len(PACKETS))


def test_header_checksum_and_single_stream_match_jax(block):
    jrx = JDenseReceiver(JConfig(**KW), **RX, header_checksum=True)
    want = jax.device_get(jrx.process(block[1]))
    got = port_rx(header_checksum=True).process(block[1])
    assert got.valid.shape == (RX["max_candidates"],)
    assert_same(got, want, n_expected=1)


def test_block_shorter_than_packet_region_matches_jax(jrx, block):
    # packed input is taken as is: a block shorter than pkt_samples is
    # padded up inside the lane gather
    rx = port_rx()
    n = rx.pkt_samples - 5 * rx.sps
    xf = np.stack([block[:, :n].real, block[:, :n].imag], axis=-2).astype(np.float32)
    assert_same(rx.process(xf), jax.device_get(jrx.process(xf)))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 50)) + 1j * rng.normal(size=(2, 50))).astype(np.complex64)
    xf = pack_iq(x, device="cpu")
    assert xf.dtype == torch.float32 and xf.shape == (2, 2, 50)
    np.testing.assert_array_equal(unpack_iq(xf).numpy(), x)
    with pytest.raises(TypeError):
        pack_iq(x.real, device="cpu")


@pytest.mark.parametrize("kw,extra", [
    (dict(sf=7, samp_rate=1e6, implicit=True), dict(demod_method="gradient")),
    (dict(sf=7, samp_rate=250e3, implicit=True), {}),
    (dict(sf=7, samp_rate=250e3), dict(low_snr=True)),
])
def test_unported_configurations_raise(kw, extra):
    """Implicit headers and low_snr, refused until they were ported, build
    as JAX's receivers do (the same engine and mode); what JAX refuses (the
    coherent mode on the gradient engine) the port refuses alike."""
    rx = DenseReceiver(LoRaConfig(**kw), **extra, device="cpu")
    jrx = JDenseReceiver(JConfig(**kw), **extra)
    assert (rx.method, rx.low_snr, rx.low_snr_threshold) == \
        (jrx.method, jrx.low_snr, jrx.low_snr_threshold)
    bad = dict(extra, low_snr=True, demod_method="gradient")
    with pytest.raises(ValueError):
        JDenseReceiver(JConfig(**kw), **bad)
    with pytest.raises(ValueError):
        DenseReceiver(LoRaConfig(**kw), **bad, device="cpu")


def test_load_tables_checks_geometry(jrx):
    rx = port_rx(kw=dict(KW, samp_rate=500e3), demod_method="fft")
    with pytest.raises(ValueError, match="expected"):
        load_tables(rx, jax_tables(jrx))
    with pytest.raises(KeyError):
        load_tables(port_rx(), {k: v for k, v in jax_tables(jrx).items() if k != "pay_lut"})
