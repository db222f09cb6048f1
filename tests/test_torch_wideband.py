"""The port's wideband PFB receiver and global candidate pool against
lora_tpu's, on the CPU.

SF7 CR4/8 channels at 250 ksps, M = 8 PFB channels at 2 Msps, packets
synthesized at the wideband rate and upconverted to their channel
frequencies (as tests/test_wideband.py and tests/test_pooled.py make
them). The port runs on the CPU. Held to:

- ``run()``: the same frames in the same order; channel, sample index,
  PHY header, payload and ``tap_header.frequency`` equal; ``snr`` rtol
  1e-5 and ``cfo`` atol 1 Hz (energy sums and atan2 in another order).
- ``process_pooled_planes`` on the same channel planes: ``valid``,
  ``channel``, ``start``, ``payload``, ``length``, ``hdr`` and
  ``n_dropped`` bit-equal on every lane, the lanes past the valid ones
  included; ``snr`` rtol 1e-5 and ``cfo`` atol 1 Hz on the valid lanes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lora_tpu import LoRaConfig as JConfig
from lora_tpu.channelizer import pfb_channel_freqs
from lora_tpu.ops.xfer import pack_iq as jpack_iq
from lora_tpu.rx.dense import DenseReceiver as JDenseReceiver
from lora_tpu.tx.modulator import modulate_frame as jmodulate
from lora_tpu.wideband import WidebandReceiver as JWidebandReceiver

from lora_tpu_torch import LoRaConfig, WidebandReceiver
from lora_tpu_torch.rx.dense import DenseReceiver
from lora_tpu_torch.wideband import MultiSFWidebandReceiver

M = 8
CHAN_RATE = 250e3
KW = dict(sf=7, cr=4, samp_rate=CHAN_RATE, crc=True)
RX = dict(max_candidates=2, max_symbols=16, sfd_search=12)


def capture(payloads, snr_db=45.0, seed=0, n_sym=160):
    """Packets on the given channels of one wideband capture (numpy)."""
    wide_rate = M * CHAN_RATE
    wide_cfg = JConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    sps_w = wide_cfg.samples_per_symbol
    x = np.zeros(n_sym * sps_w, np.complex128)
    freqs = pfb_channel_freqs(wide_rate, M)
    rng = np.random.default_rng(seed)
    for c, payload in payloads.items():
        pkt = jmodulate(wide_cfg, payload, snr_db=None, seed=seed)
        pos = (8 + c) * sps_w + int(rng.integers(0, 4)) * sps_w
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[c] / wide_rate * t)
    x += rng.normal(0, np.sqrt(10 ** (-snr_db / 10.0) / 2), (len(x), 2)) @ [1, 1j]
    return x.astype(np.complex64)


THREE = {1: b"\x11\xaa", 3: b"\x33\xbb", 6: b"\x66\xcc"}
ALL = {c: bytes([c, 0x5A]) for c in range(M)}
FOUR = {c: bytes([c, 0x77]) for c in range(4)}


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.sample_index, g.phy_header.to_bytes(), g.payload) == \
            (w.channel, w.sample_index, w.phy_header.to_bytes(), w.payload)
        assert g.tap_header.frequency == w.tap_header.frequency
        assert (g.tap_header.sf, g.tap_header.sync_word) == \
            (w.tap_header.sf, w.tap_header.sync_word)
        assert g.snr == pytest.approx(w.snr, rel=1e-5)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


@pytest.mark.parametrize("payloads,pool,active,dtype", [
    (THREE, None, None, "float32"),
    (THREE, 8, None, "float32"),
    (THREE, None, [3, 5], "float32"),
    (ALL, None, None, "float32"),
    (ALL, 4, None, "float32"),          # pool smaller than the packets
    (FOUR, 4, None, "float32"),         # real packets win the pool over ghosts
    (THREE, 8, None, "bfloat16"),
], ids=["three", "three-pool8", "active-subset", "all", "all-pool4", "four-pool4",
        "bf16-pool8"])
def test_run_matches_jax(payloads, pool, active, dtype):
    x = capture(payloads, snr_db=50.0 if payloads is ALL else 45.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jwr = JWidebandReceiver(JConfig(**KW), M, active_channels=active, pool=pool,
                            plane_dtype=jdt, **RX)
    wr = WidebandReceiver(LoRaConfig(**KW), M, active_channels=active, pool=pool,
                          plane_dtype=tdt, device="cpu", **RX)
    want = jwr.run(x)
    got = wr.run(x)
    assert_frames_equal(got, want)
    expect = {c: p for c, p in payloads.items() if active is None or c in active}
    if pool is None or pool >= len(payloads):
        assert {f.channel: f.payload[:2] for f in got} == expect


def direct_planes(rx_j):
    """A plain [4, 2, L] channel batch, no PFB: one packet a channel at
    channel rate (tests/test_pooled.py:67-92)."""
    cfg = JConfig(**KW)
    sps = cfg.samples_per_symbol
    rows = [jmodulate(cfg, bytes([c]), pad_before=(4 + c) * sps, pad_after=4 * sps,
                      snr_db=40.0, seed=c) for c in range(4)]
    L = -(-max(len(r) for r in rows) // sps) * sps + rx_j.pkt_samples
    return np.asarray(jpack_iq(np.stack([np.pad(r, (0, L - len(r))) for r in rows])))


@pytest.mark.parametrize("source,pool,per_channel", [
    ("pfb", 8, 4), ("pfb", 3, 4), ("pfb", 64, 2), ("direct", 6, 4)])
def test_pooled_planes_match_jax(source, pool, per_channel):
    """The same channel planes through both pooled paths; ``pool = 64 >
    C * per_channel`` keeps ``C * per_channel`` lanes, as JAX's slice."""
    rx_j = JDenseReceiver(JConfig(**KW), **RX)
    rx_t = DenseReceiver(LoRaConfig(**KW), **RX, device="cpu")
    if source == "pfb":
        jwr = JWidebandReceiver(JConfig(**KW), M, **RX)
        pad = np.pad(capture(ALL, snr_db=50.0), (0, rx_j.pkt_samples * M))
        cp = np.array(jwr.pfb.planes(jnp.asarray(jpack_iq(pad))))   # [M, 2, n]
    else:
        cp = direct_planes(rx_j)
    C = cp.shape[0]
    want = jax.device_get(jax.jit(
        lambda a: rx_j.process_pooled_planes(a, pool, per_channel))(jnp.asarray(cp)))
    got = rx_t.process_pooled_planes(torch.from_numpy(cp), pool, per_channel)
    assert got.valid.shape == (min(pool, C * per_channel),)
    for f in ("valid", "channel", "start", "payload", "length", "hdr", "n_dropped"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    valid = np.asarray(want.valid)
    assert valid.sum() == min(pool, C)
    np.testing.assert_allclose(got.snr.numpy()[valid], np.asarray(want.snr)[valid], rtol=1e-5)
    np.testing.assert_allclose(got.cfo.numpy()[valid], np.asarray(want.cfo)[valid], atol=1.0)


def test_packed_and_tensor_inputs_match_complex():
    """Host packed planes and a tensor give the same result as complex
    input padded the same way."""
    x = capture(THREE)
    wr = WidebandReceiver(LoRaConfig(**KW), M, pool=8, device="cpu", **RX)
    pad = np.pad(x, (0, wr.rx.pkt_samples * M))
    xf = np.stack([pad.real, pad.imag]).astype(np.float32)
    a, b, c = wr.process(x), wr.process(xf), wr.process(torch.from_numpy(xf))
    for f in ("valid", "channel", "start", "payload"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(getattr(a, f), getattr(c, f))


def test_unported_and_bad_options_raise():
    with pytest.raises(ValueError, match="sfs"):
        MultiSFWidebandReceiver(LoRaConfig(**KW), M, sfs=(), device="cpu")
    with pytest.raises(TypeError):
        WidebandReceiver(LoRaConfig(**KW), M, plane_dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WidebandReceiver(LoRaConfig(**KW), M)
