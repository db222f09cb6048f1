"""The port's multi-SF gateway and its shared detection substrate against
lora_tpu's, on the CPU.

- ``lag_rows_planes`` (the plain version of the multi-lag kernel) against
  JAX's plain version and against the Pallas kernel in interpret mode on
  its valid rows: energies rtol 1e-5; each lag product within ``1e-5 *
  sqrt(e_r * e_{r+l})`` (float32 sums in another order, on the
  Cauchy-Schwarz scale of the product).
- ``metrics_from_lag_rows`` and ``multi_sf_detection_metrics`` against
  JAX's per-SF ``detection_metrics_planes``: corr atol 2e-5 (the
  detection kernel's tolerance), energies rtol 1e-5.
- ``MultiSFWidebandReceiver`` against JAX's on tests/test_multi_sf.py's
  captures, with each SF's receiver on the port's own tables or on JAX's:
  frames equal field by field (snr rtol 1e-5, cfo atol 1 Hz), and each
  SF's ``PooledResult`` bit-equal on its integer fields, lanes past the
  valid ones included; the per-SF detection (``shared_detection=False``)
  gives what the shared one gives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lora_tpu.config import LoRaConfig as JConfig
from lora_tpu.ops.pallas_kernels import lag_rows_pallas
from lora_tpu.rx import frontend as jfrontend
from lora_tpu.wideband import MultiSFWidebandReceiver as JMultiSF

from lora_tpu_torch import LoRaConfig, MultiSFWidebandReceiver
from lora_tpu_torch.convert import load_tables
from lora_tpu_torch.ops import cuda_kernels
from lora_tpu_torch.ops.cuda_kernels import _lag_vector_width, lag_rows_kernel
from lora_tpu_torch.rx.frontend import (detection_metrics_planes, lag_rows_planes,
                                        metrics_from_lag_rows,
                                        multi_sf_detection_metrics)

from test_multi_sf import _band_with_packets
from test_torch_ops import jax_tables


def _planes(C, L, seed=0):
    return np.random.default_rng(seed).normal(0, 1.0, (C, 2, L)).astype(np.float32)


def assert_rows_close(got, want, lags, valid=None):
    """``got``/``want``: ``(e, {lag: (q_re, q_im)})``; ``valid``: compare
    only rows ``r < R - lag`` of each product (the Pallas contract)."""
    e_g, qs_g = got
    e_w, qs_w = (np.asarray(want[0]), {m: tuple(map(np.asarray, q)) for m, q in want[1].items()})
    e_g = e_g.numpy()
    np.testing.assert_allclose(e_g, e_w, rtol=1e-5)
    R = e_w.shape[-1]
    for m in lags:
        n = R - m if valid else R
        scale = np.sqrt(e_w[..., :n] * np.pad(e_w, [(0, 0)] * (e_w.ndim - 1) + [(0, m)])[..., m:m + n])
        for a, b in zip(qs_g[m], qs_w[m]):
            assert a.shape == e_g.shape and a.dtype == torch.float32
            assert np.all(np.abs(a.numpy()[..., :n] - b[..., :n]) <= 1e-5 * scale + 1e-30)


@pytest.mark.parametrize("sps_min,ms", [
    (128, (1, 2, 4, 8, 16, 32)),   # SF7..12 at decim 1
    (256, (1, 2, 4)),              # SF7..9 at decim 2
    (128, (1, 3)),                 # a multiple that is not a power of two
])
def test_lag_rows_match_jax(sps_min, ms):
    C, R = 3, 37 * max(ms)
    xf = _planes(C, R * sps_min + 17)     # a ragged tail past the row grid
    got = lag_rows_planes(torch.from_numpy(xf), sps_min, ms)
    want = jfrontend.lag_rows_planes(jnp.asarray(xf), sps_min, ms)
    assert_rows_close(got, want, ms)
    for m in ms:
        corr, e1, e2 = metrics_from_lag_rows(got[0], *got[1][m], m)
        ref = jfrontend.detection_metrics_planes(jnp.asarray(xf), m * sps_min)
        np.testing.assert_allclose(corr.numpy(), np.asarray(ref[0]), rtol=0, atol=2e-5)
        np.testing.assert_allclose(e1.numpy(), np.asarray(ref[1]), rtol=1e-5)
        np.testing.assert_allclose(e2.numpy(), np.asarray(ref[2]), rtol=1e-5)


@pytest.mark.parametrize("R", [96, 99, 40], ids=["exact", "ragged", "single-tile-ragged"])
def test_lag_rows_match_pallas_interpret(R):
    """tests/test_multi_lag_metrics.py:59-99's geometries: the Pallas
    kernel's rows ``r < R - lag`` (the rest are unspecified there)."""
    sps_min, ms = 128, (1, 2, 4, 8, 16, 32)
    C = 1 if R == 40 else 2
    xf = _planes(C, R * sps_min, seed=2 if R == 40 else 1)
    want = lag_rows_pallas(jnp.asarray(xf), sps_min, ms, interpret=True)
    assert want is not None
    assert_rows_close(lag_rows_planes(torch.from_numpy(xf), sps_min, ms), want, ms,
                      valid=True)


def test_lag_rows_bf16_and_lags_past_the_rows():
    """bf16 planes sum in float32 like JAX's; a lag >= R gives zeros."""
    xf = torch.from_numpy(_planes(2, 9 * 100 + 3, seed=3)).to(torch.bfloat16)
    got = lag_rows_planes(xf, 100, (1, 2, 9, 40))
    want = jfrontend.lag_rows_planes(jnp.asarray(xf.float().numpy()).astype(jnp.bfloat16),
                                     100, (1, 2, 9, 40))
    assert_rows_close(got, want, (1, 2, 9, 40))
    for m in (9, 40):
        assert not got[1][m][0].any() and not got[1][m][1].any()
    assert not got[1][2][0][..., -2:].any()


def test_lag_rows_kernel_on_cpu_is_the_plain_version():
    xf = torch.from_numpy(_planes(2, 12 * 64, seed=4))
    before = lag_rows_kernel.launches
    e, qs = lag_rows_kernel(xf, 64, {4, 1, 2, 2})
    assert lag_rows_kernel.launches == before
    e_p, qs_p = lag_rows_planes(xf, 64, (1, 2, 4))
    assert torch.equal(e, e_p) and sorted(qs) == [1, 2, 4]
    for m in qs:
        assert torch.equal(qs[m][0], qs_p[m][0]) and torch.equal(qs[m][1], qs_p[m][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lag_rows_kernel_reads_pitched_planes(dtype):
    """The channelizer's view (``buf[..., :n]`` of a ``[C, 2, n_pad]``
    buffer) gives what its contiguous copy gives, and what JAX's plain
    version gives on the same input."""
    sps, ms, n = 128, (1, 2, 4, 8, 16, 32), 41 * 128 + 17
    buf = torch.from_numpy(_planes(3, n + 7, seed=5)).to(getattr(torch, dtype))
    view = buf[..., :n]
    assert not view.is_contiguous() and view.stride(-2) == n + 7
    got = lag_rows_kernel(view, sps, ms)
    same = lag_rows_kernel(view.contiguous(), sps, ms)
    assert torch.equal(got[0], same[0])
    for m in ms:
        assert torch.equal(got[1][m][0], same[1][m][0]) and torch.equal(got[1][m][1], same[1][m][1])
    want = jfrontend.lag_rows_planes(jnp.asarray(view.float().numpy()).astype(getattr(jnp, dtype)),
                                     sps, ms)
    assert_rows_close(got, want, ms)


def _width_case(case):
    """Planes for ``_lag_vector_width`` and the width it must pick."""
    n = 1759 * 256 + 247
    if case == "gateway-view-bf16":      # the channelizer's view: pitch n + 1
        return torch.zeros((4, 2, n + 1), dtype=torch.bfloat16)[..., :n], 256, 8
    if case == "pitched-f32":
        return torch.zeros((4, 2, n + 1))[..., :n], 256, 4
    if case == "contiguous-odd-length":
        return torch.zeros((4, 2, n), dtype=torch.bfloat16), 256, 1
    if case == "unaligned-pitch":
        return torch.zeros((4, 2, n + 4), dtype=torch.bfloat16)[..., :n], 256, 1
    if case == "sps-off-the-grid":
        return torch.zeros((4, 2, 100 * 30)), 100, 4
    if case == "bf16-sps-off-the-grid":
        return torch.zeros((4, 2, 100 * 30), dtype=torch.bfloat16), 100, 1
    if case == "base-off-the-grid":
        return torch.zeros((4, 2, 4104))[..., 1:4097], 256, 1
    return torch.zeros((2, 4100))[:, :4096].reshape(1, 2, 4096), 256, 4   # one stream


@pytest.mark.parametrize("case", ["gateway-view-bf16", "pitched-f32", "contiguous-odd-length",
                                  "unaligned-pitch", "sps-off-the-grid", "bf16-sps-off-the-grid",
                                  "base-off-the-grid", "one-stream"])
def test_lag_vector_width(case):
    """The multi-lag kernel copies 16 bytes at a time (4 float32 or 8
    bf16 samples) where the planes' base, both strides and sps allow it,
    else one sample."""
    x3, sps, want = _width_case(case)
    assert _lag_vector_width(x3, sps) == want


@pytest.mark.parametrize("case", ["lag-0", "no-lags", "no-row", "fp16", "three-planes"])
def test_lag_rows_kernel_refuses(case):
    xf, sps, lags = torch.zeros((2, 2, 1024)), 128, (1, 2)
    if case == "lag-0":
        lags = (0, 1)
    elif case == "no-lags":
        lags = ()
    elif case == "no-row":
        sps = 2048
    elif case == "fp16":
        xf = xf.half()
    else:
        xf = torch.zeros((2, 3, 1024))
    with pytest.raises((TypeError, ValueError)):
        lag_rows_kernel(xf, sps, lags)


def test_multi_sf_metrics_dict_matches_per_sf():
    sps_by_sf = {7: 256, 8: 512, 10: 2048}
    xf = _planes(2, 2048 * 9 + 5)
    out = multi_sf_detection_metrics(torch.from_numpy(xf), sps_by_sf)
    assert sorted(out) == [7, 8, 10]
    for sf, sps in sps_by_sf.items():
        ref = jfrontend.detection_metrics_planes(jnp.asarray(xf), sps)
        own = detection_metrics_planes(torch.from_numpy(xf), sps)
        for got, want, mine in zip(out[sf], ref, own):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
            np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=1e-5, atol=2e-5)
    with pytest.raises(ValueError, match="commensurate"):
        multi_sf_detection_metrics(torch.from_numpy(xf), {7: 256, 8: 384})


# ------------------------------------------------------------------ gateway
def _receivers(M, sfs, tables, **kw):
    cfg = dict(sf=7, cr=1, samp_rate=250e3, crc=True)
    jwr = JMultiSF(JConfig(**cfg), M, sfs=sfs, demod_method="fft", **kw)
    wr = MultiSFWidebandReceiver(LoRaConfig(**cfg), M, sfs=sfs, demod_method="fft",
                                 device="cpu", **kw)
    if tables == "loaded":
        for sf in wr.sfs:
            load_tables(wr.rxs[sf], jax_tables(jwr.rxs[sf]))
    return jwr, wr


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.sample_index, g.phy_header.to_bytes(), g.payload) == \
            (w.channel, w.sample_index, w.phy_header.to_bytes(), w.payload)
        assert (g.tap_header.sf, g.tap_header.frequency, g.tap_header.sync_word) == \
            (w.tap_header.sf, w.tap_header.frequency, w.tap_header.sync_word)
        assert g.snr == pytest.approx(w.snr, rel=1e-5)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


def assert_pooled_equal(got, want):
    for f in ("valid", "channel", "start", "payload", "length", "hdr", "n_dropped"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    valid = np.asarray(want.valid)
    np.testing.assert_allclose(got.snr.numpy()[valid], np.asarray(want.snr)[valid], rtol=1e-5)
    np.testing.assert_allclose(got.cfo.numpy()[valid], np.asarray(want.cfo)[valid], atol=1.0)


@pytest.mark.parametrize("tables", ["own", "loaded"])
def test_gateway_run_matches_jax(tables):
    """tests/test_multi_sf.py:42-69: SF7-9 on 8 channels, one packet each
    at SF7, 8 and 9."""
    M = 8
    placements = [(7, 2, b"\x11\x22"), (8, 5, b"\x33\x44"), (9, 6, b"\x55\x66")]
    jwr, wr = _receivers(M, (7, 8, 9), tables, pool=8, max_candidates=2, max_symbols=16,
                         sfd_search=10)
    sps9 = 4 * 256
    L = (2 * sps9 + 30 * sps9 + wr.max_pkt_samples * 2) * M
    assert wr.max_pkt_samples == jwr.max_pkt_samples
    x = _band_with_packets(JConfig(sf=7, cr=1, samp_rate=250e3, crc=True), M, placements, L)
    want = jwr.run(x)
    got = wr.run(x)
    assert {(f.tap_header.sf, f.channel): f.payload[:2] for f in got} == \
        {(sf, c): p for sf, c, p in placements}
    assert_frames_equal(got, want)


@pytest.fixture(scope="module")
def two_sf():
    """tests/test_multi_sf.py:78-93: SF7 and SF8 on 4 channels, one SF7
    packet; both receivers' per-SF results on it."""
    M = 4
    jwr, wr = _receivers(M, (7, 8), "own", pool=4, max_candidates=2, max_symbols=12,
                         sfd_search=10)
    L = (wr.max_pkt_samples * 2 + 40 * 256) * M
    x = _band_with_packets(JConfig(sf=7, cr=1, samp_rate=250e3, crc=True), M,
                           [(7, 1, b"\xab")], L)
    return x, jax.device_get(jwr.process(x)), wr


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-sf"])
def test_gateway_pooled_results_match_jax(two_sf, shared):
    x, want, wr = two_sf
    wr.shared_detection = shared
    got = wr.process(x)
    assert sorted(got) == [7, 8]
    for sf in (7, 8):
        assert got[sf].valid.shape == (4,)
        assert_pooled_equal(got[sf], want[sf])
    g = int(np.nonzero(got[7].valid.numpy())[0][0])
    assert bytes(got[7].payload[g, :1].numpy()) == b"\xab"
    assert not got[8].valid.any()


def test_gateway_shared_and_per_sf_detection_agree(two_sf):
    x, _, wr = two_sf
    xf = torch.from_numpy(np.stack([x.real, x.imag]).astype(np.float32))
    res = {}
    for shared in (True, False):
        wr.shared_detection = shared
        res[shared] = wr.process(xf)
    wr.shared_detection = True
    for sf in wr.sfs:
        for f in ("valid", "channel", "start", "payload", "length", "hdr", "n_dropped"):
            assert torch.equal(getattr(res[True][sf], f), getattr(res[False][sf], f)), f


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-sf"])
def test_gateway_hands_over_the_channel_planes(two_sf, monkeypatch, shared):
    """With shared detection the multi-lag pass and every SF's Phase B read
    the channelizer's pitched view, uncopied; the per-SF detection copies
    the planes once for all SFs. Both decode the same lanes."""
    x, _, wr = two_sf
    n_vec = len(x) // wr.M
    if (n_vec - wr.pfb.K + 1) % 8 == 0:    # n_out off the pitch: the view is not contiguous
        n_vec -= 1
    xf = torch.from_numpy(np.stack([x.real, x.imag])[:, :n_vec * wr.M].astype(np.float32))
    view = wr._channel_planes(xf)
    assert not view.is_contiguous()
    monkeypatch.setattr(wr, "shared_detection", not shared)
    other = wr.process(xf)
    monkeypatch.setattr(wr, "shared_detection", shared)
    seen, k3 = [], cuda_kernels.lag_rows_kernel

    def spy_k3(planes, *a):
        seen.append(("K3", planes.stride(), planes.is_contiguous()))
        return k3(planes, *a)

    def spy_stage(sf, stage):
        def fn(planes, *a, **kw):
            seen.append((sf, planes.stride(), planes.is_contiguous()))
            return stage(planes, *a, **kw)
        return fn

    monkeypatch.setattr(cuda_kernels, "lag_rows_kernel", spy_k3)
    for sf, rx in wr.rxs.items():
        monkeypatch.setattr(rx, "process_pooled_planes", spy_stage(sf, rx.process_pooled_planes))
    got = wr.process(xf)
    if shared:
        assert [w for w, _, _ in seen] == ["K3", 7, 8]
        assert all(st == view.stride() and not cont for _, st, cont in seen)
    else:
        assert [w for w, _, _ in seen] == [7, 8] and all(cont for _, _, cont in seen)
    for sf in wr.sfs:
        for f in ("valid", "channel", "start", "payload", "length", "hdr", "n_dropped"):
            assert torch.equal(getattr(got[sf], f), getattr(other[sf], f)), f


def test_gateway_options():
    cfg = LoRaConfig(sf=7, cr=1, samp_rate=250e3, crc=True)
    with pytest.raises(ValueError):
        MultiSFWidebandReceiver(cfg, 8, sfs=(), device="cpu")
    wr = MultiSFWidebandReceiver(cfg, 4, sfs=(8, 7, 8), max_symbols=12, device="cpu")
    assert wr.sfs == (8, 7) and sorted(wr.rxs) == [7, 8]
    assert [wr.rxs[sf].cfg.sf for sf in wr.sfs] == [8, 7]
    assert wr.max_pkt_samples == wr.rxs[8].pkt_samples
    with pytest.raises(TypeError):
        MultiSFWidebandReceiver(cfg, 4, plane_dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiSFWidebandReceiver(cfg, 4)
