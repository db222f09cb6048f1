"""The port on the card: each kernel against its plain torch version, the
dense receiver (both engines), wideband, multi-SF gateway and plan
gateway receivers on the card against the port on the CPU, and the
kernel studies; the receiver facade, implicit headers, ``low_snr`` and
``debug_trace`` against the CPU; the parity engine and one flowgraph
receiver of each channelizer route against the CPU; the four sharded
functions on a 4-shard mesh of the card against a mesh of CPU shards, a
CPU receiver on that mesh (a replica on the card) against a card
receiver, and an NCCL group of one rank against the one-shard mesh; each
stage of ``lora_tpu_torch.bench`` at a small size against the CPU; and
(``slow``) the 13-suite accuracy matrix on the card, dense and parity
engines (``LORA_TORCH_REPORTS=DIR`` keeps its reports).

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: corr atol 2e-5, energies rtol 1e-5 (float32 sums in another
order); the polyphase FIR bit-equal to its plain version (the same
products summed in the same order, cast once) for every dtype pair, in
its vector and its scalar instantiation; the multi-lag rows' energies rtol 1e-5 and each lag product within ``1e-5 *
sqrt(e_r * e_{r+l})``; the fused channelizer, on each of its two
kernels (the path rule's counter checked), within ``2 * (2DK + 4) *
2^-24 * sum|g2 row| * max|x|`` (twice the worst-case float32 rounding of
a sum of 2DK products, plus the ramp's products); receiver results as in
test_torch_dense.py."""

import numpy as np
import pytest
import torch

from lora_tpu_torch import (DenseReceiver, LoRaConfig, MultiSFWidebandReceiver, PlanGateway,
                            WidebandReceiver, tracing)
from lora_tpu_torch.channelizer import fused_tables, pfb_channel_freqs
from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                             detection_metrics_planes,
                                             detection_metrics_tile_kernel,
                                             detection_metrics_wm_kernel,
                                             detection_metrics_wm_planes,
                                             fused_chan_path, fused_channelize_kernel,
                                             fused_channelize_planes,
                                             lag_rows_kernel, lag_rows_planes,
                                             _lag_vector_width, _pfb_vector_width, pfb_fir_kernel,
                                             pfb_fir_planes)
from lora_tpu_torch.ops.xfer import pack_iq
from lora_tpu_torch.tx.modulator import modulate_frame

from test_torch_sharding_replica import same_sharded, sharding_cases

pytestmark = pytest.mark.cuda

# sps, windows, tail samples: SF7 at 1 Msps, SF10, a ragged block, sps off
# the 128 grid, an odd sps (scalar loads)
GEOMS = [(1024, 64, 0), (8192, 16, 0), (1024, 37, 341), (1000, 40, 0), (1001, 9, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    torch.testing.assert_close(got[0].cpu(), want[0].cpu(), rtol=0, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sps,k1,tail", GEOMS)
def test_kernel_matches_plain(cuda_device, sps, k1, tail, dtype):
    rng = np.random.default_rng(sps + k1)
    x = rng.normal(size=(3, 2, k1 * sps + tail)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device).to(dtype)
    before = detection_metrics_kernel.launches
    got = detection_metrics_kernel(x, sps)
    torch.cuda.synchronize()
    assert detection_metrics_kernel.launches == before + 1
    assert all(g.is_cuda and g.dtype == torch.float32 for g in got)
    _close(got, detection_metrics_planes(x, sps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sps,k1,tail", GEOMS)
def test_tile_kernel_matches_plain(cuda_device, sps, k1, tail, dtype):
    rng = np.random.default_rng(sps + k1 + 1)
    x = rng.normal(size=(3, 2, k1 * sps + tail)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device).to(dtype)
    before = detection_metrics_tile_kernel.launches
    got = detection_metrics_kernel(x, sps, variant="tile")
    torch.cuda.synchronize()
    assert detection_metrics_tile_kernel.launches == before + 1
    assert all(g.is_cuda and g.dtype == torch.float32 for g in got)
    _close(got, detection_metrics_planes(x, sps))


# sps, windows: the GEOMS shapes, and window counts that are a multiple of
# no tile
@pytest.mark.parametrize("sps,k1", [(g[0], g[1]) for g in GEOMS] + [(128, 1031), (3, 67)])
def test_wm_kernel_matches_plain(cuda_device, sps, k1):
    rng = np.random.default_rng(sps + k1 + 2)
    xw = torch.from_numpy(rng.normal(size=(3, k1, 2, sps)).astype(np.float32)).to(cuda_device)
    xw[1, 5] = 0.0     # a silent window
    before = detection_metrics_wm_kernel.launches
    got = detection_metrics_wm_kernel(xw)
    torch.cuda.synchronize()
    assert detection_metrics_wm_kernel.launches == before + 1
    want = detection_metrics_wm_planes(xw)
    torch.testing.assert_close(got[0].cpu(), want[0].cpu(), rtol=0, atol=2e-5)
    torch.testing.assert_close(got[1].cpu(), want[1].cpu(), rtol=1e-5, atol=0)
    assert float(got[0][1, 5]) == 0.0


def test_wm_kernel_refuses_non_contiguous(cuda_device):
    xw = torch.zeros((2, 8, 2, 256), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        detection_metrics_wm_kernel(xw)


def test_kernel_studies_on_card(cuda_device):
    from lora_tpu_torch.tools import profile_detect, profile_packing

    before = (detection_metrics_kernel.launches, detection_metrics_tile_kernel.launches)
    res = profile_detect.main(["2", "64"], iters=2, rounds=2)
    assert (detection_metrics_kernel.launches - before[0],
            detection_metrics_tile_kernel.launches - before[1]) == (res["calls"]["pp"],
                                                                    res["calls"]["tile"])
    assert min(res["ms"].values()) > 0.0
    res = profile_packing.main(["2"], iters=2, rounds=2)
    assert set(res["ms"]) == {"pp", "wm", "plain"} and min(res["ms"].values()) > 0.0


def test_kernel_single_stream_and_cpu_agree(cuda_device):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 9 * 256)).astype(np.float32))
    got = detection_metrics_kernel(x.to(cuda_device), 256)
    assert got[0].shape == (8,)
    _close(got, detection_metrics_planes(x, 256))


def test_kernel_refuses_non_contiguous(cuda_device):
    x = torch.zeros((2, 2, 4096), device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        detection_metrics_kernel(x, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_receiver_on_card_matches_cpu(cuda_device, dtype):
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(9)
    x = (0.003 * (rng.normal(size=(3, 480 * sps)) + 1j * rng.normal(size=(3, 480 * sps))))
    x = x.astype(np.complex64)
    n_packets = 0
    for c in range(3):
        for sym, cfo in ((5 + 7 * c, 150.0 * c), (200 + 30 * c, -200.0)):
            pkt = modulate_frame(cfg, b"\xde\xad\xbe\xef" + bytes([c]), cfo_hz=cfo,
                                 snr_db=30.0, seed=sym)
            x[c, sym * sps + 13 * c: sym * sps + 13 * c + len(pkt)] += pkt
            n_packets += 1
    kw = dict(max_candidates=4, max_symbols=24, sfd_search=12)
    rx_gpu = DenseReceiver(cfg, **kw, device=cuda_device)
    rx_cpu = DenseReceiver(cfg, **kw, device="cpu")
    pad = np.pad(x, [(0, 0), (0, rx_cpu.pkt_samples)])
    before = detection_metrics_kernel.launches
    got = rx_gpu.process(pack_iq(pad, dtype=dtype, device=cuda_device))
    torch.cuda.synchronize()
    assert detection_metrics_kernel.launches == before + 1
    want = rx_cpu.process(pack_iq(pad, dtype=dtype, device="cpu"))
    valid = want.valid.numpy()
    assert valid.sum() == n_packets
    np.testing.assert_array_equal(got.valid.cpu().numpy(), valid)
    np.testing.assert_array_equal(got.start.cpu().numpy(), want.start.numpy())
    for f in ("payload", "length", "hdr"):
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy()[valid],
                                      getattr(want, f).numpy()[valid])
    np.testing.assert_allclose(got.snr.cpu().numpy()[valid], want.snr.numpy()[valid],
                               rtol=1e-5)
    np.testing.assert_allclose(got.cfo.cpu().numpy()[valid], want.cfo.numpy()[valid],
                               atol=1.0)


def test_gradient_receiver_on_card_matches_cpu(cuda_device):
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(19)
    x = (0.003 * (rng.normal(size=(2, 200 * sps)) + 1j * rng.normal(size=(2, 200 * sps))))
    x = x.astype(np.complex64)
    for c in range(2):
        for sym, cfo in ((4 + 9 * c, 210.0 * c), (80 + 20 * c, -330.0)):
            pkt = modulate_frame(cfg, b"\xde\xad\xbe\xef" + bytes([c]), cfo_hz=cfo,
                                 snr_db=30.0, seed=sym)
            x[c, sym * sps + 101 * c: sym * sps + 101 * c + len(pkt)] += pkt
    kw = dict(max_candidates=3, max_symbols=24, sfd_search=12)
    rx_gpu = DenseReceiver(cfg, **kw, device=cuda_device)
    rx_cpu = DenseReceiver(cfg, **kw, device="cpu")
    assert rx_gpu.method == rx_cpu.method == "gradient"
    got = rx_gpu.run(x)
    want = rx_cpu.run(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.phy_header.to_bytes(), g.payload, g.channel, g.sample_index) == \
            (w.phy_header.to_bytes(), w.payload, w.channel, w.sample_index)
        assert g.crc_ok is True
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)
        assert g.snr == pytest.approx(w.snr, rel=1e-5)


# M, n_vec, K, tail samples: the bench branch count, the gateway's, ragged
# branch tiles (8, 1000), n_vec off the step grid (the last run not full),
# K = 1, 16 and 37 (tap passes of 8, 4, 2 and 1), one output row; then the
# scalar instantiation: L not a multiple of 4 samples (an unaligned plane
# stride), M = 1001 and M = 6; then the narrow tile (tiles of 2-32 threads,
# both planes a block) at the coarse filterbank's K = 13: M = 1, 2, 4, 8
# and 16 with n_vec off the step grid, M = 8 on it (256 rows a step for
# float32 and bf16 planes), n_vec = K; and M = 124 (31 chunks of 4, a
# ragged 32-thread tile)
FIR_GEOMS = [(1024, 200, 10, 0), (256, 1500, 10, 0), (8, 700, 10, 0), (1000, 41, 10, 0),
             (128, 533, 10, 0), (256, 90, 1, 0), (256, 90, 16, 0), (64, 100, 37, 0),
             (512, 10, 10, 0), (1024, 50, 10, 333), (1001, 40, 10, 0), (6, 700, 10, 0),
             (1, 9001, 13, 0), (2, 4001, 13, 0), (4, 3001, 13, 0), (8, 1001, 13, 0),
             (16, 601, 13, 0), (8, 256 * 4 + 12, 13, 0), (8, 13, 13, 0), (1, 13, 13, 0),
             (124, 300, 10, 0)]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n_vec,K,tail", FIR_GEOMS)
def test_pfb_fir_kernel_matches_plain(cuda_device, M, n_vec, K, tail, in_dtype, out):
    rng = np.random.default_rng(M + n_vec + K)
    x = torch.from_numpy(rng.normal(size=(2, n_vec * M + tail)).astype(np.float32))
    h = torch.from_numpy(0.1 * rng.normal(size=(K, M)).astype(np.float32))
    x, h = x.to(cuda_device).to(in_dtype), h.to(cuda_device)
    before = pfb_fir_kernel.launches
    got = pfb_fir_kernel(x, h, out)
    torch.cuda.synchronize()
    assert pfb_fir_kernel.launches == before + 1
    want = pfb_fir_planes(x, h, out)
    assert got.shape == want.shape == (2, n_vec - K + 1, M) and got.dtype == out
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,vector", [(5000, True), (4103, False)])
def test_pfb_fir_kernel_reads_a_strided_view(cuda_device, stride, vector, in_dtype, out):
    """Planes cut from a longer buffer keep its row stride: no copy. An
    aligned stride takes the vector instantiation, an odd one the scalar."""
    x = torch.randn((2, stride), device=cuda_device).to(in_dtype)[:, :4100]
    h = torch.randn((10, 100 if in_dtype == torch.float32 else 200), device=cuda_device)
    want_width = 16 // x.element_size() if vector else 1
    assert _pfb_vector_width(x, h, torch.empty((1, 2, h.shape[1]), dtype=out,
                                               device=cuda_device)) == want_width
    assert torch.equal(pfb_fir_kernel(x, h, out), pfb_fir_planes(x, h, out))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,vector", [(8 * 900 + 8, True), (8 * 900 + 3, False)])
def test_pfb_fir_kernel_reads_a_strided_view_at_m8(cuda_device, stride, vector, in_dtype, out):
    """The narrow tile (M = 8) on planes cut from a longer buffer: an
    aligned stride takes the vector instantiation, an odd one the scalar."""
    x = torch.randn((2, stride), device=cuda_device).to(in_dtype)[:, :8 * 900]
    h = torch.randn((13, 8), device=cuda_device)
    assert _pfb_vector_width(x, h, torch.empty((1, 2, 8), dtype=out, device=cuda_device)) == (
        16 // x.element_size() if vector else 1)
    assert torch.equal(pfb_fir_kernel(x, h, out), pfb_fir_planes(x, h, out))


def test_pfb_fir_kernel_writes_into_a_padded_buffer(cuda_device):
    x = torch.randn((2, 64 * 50), device=cuda_device)
    h = torch.randn((10, 64), device=cuda_device)
    buf = torch.full((48, 2, 64), 7.0, device=cuda_device)
    got = pfb_fir_kernel(x, h, out=buf)
    assert got.data_ptr() == buf.data_ptr()
    torch.testing.assert_close(got, pfb_fir_planes(x, h), rtol=0, atol=0)
    assert bool((buf[41:] == 7.0).all())


def test_pfb_fir_kernel_refuses_a_ring_past_shared_memory(cuda_device):
    """The kernel keeps K - 1 + 3 steps of rows in shared memory: 359 taps a
    branch fit for aligned float32 planes, 360 are refused at launch."""
    for K, fits in ((359, True), (360, False)):
        x = torch.randn((2, 128 * (K + 3)), device=cuda_device)
        h = 0.01 * torch.randn((K, 128), device=cuda_device)
        if fits:
            assert torch.equal(pfb_fir_kernel(x, h), pfb_fir_planes(x, h))
        else:
            with pytest.raises(RuntimeError, match="pfb_fir launch failed"):
                pfb_fir_kernel(x, h)


@pytest.mark.parametrize("M,parent_k,limit", [(8, 359, 3199), (1, 1433, 28050)])
def test_pfb_fir_kernel_narrow_tile_takes_the_parents_k(cuda_device, M, parent_k, limit):
    """The narrow tile (float32 planes and output) launches, bit-equal, at
    the largest K the 32-thread tile took at this M (359 at M = 8, 1,433 at
    M = 1, scalar), and at its own limit with its row groups cut down; one
    tap more is refused at launch."""
    for K, fits in ((parent_k, True), (limit, True), (limit + 1, False)):
        x = torch.randn((2, M * (K + 40)), device=cuda_device)
        h = 0.01 * torch.randn((K, M), device=cuda_device)
        if fits:
            assert torch.equal(pfb_fir_kernel(x, h), pfb_fir_planes(x, h))
        else:
            with pytest.raises(RuntimeError, match="pfb_fir launch failed"):
                pfb_fir_kernel(x, h)


@pytest.mark.parametrize("case", ["fp16", "three-planes", "strided-rows", "taps-on-cpu",
                                  "f64-taps"])
def test_pfb_fir_kernel_refuses(cuda_device, case):
    x = torch.zeros((2, 4096), device=cuda_device)
    h = torch.ones((4, 64), device=cuda_device)
    if case == "fp16":
        x = x.half()
    elif case == "three-planes":
        x = torch.zeros((3, 4096), device=cuda_device)
    elif case == "strided-rows":
        x = torch.zeros((2, 8192), device=cuda_device)[:, ::2]
    elif case == "taps-on-cpu":
        h = h.cpu()
    else:
        h = h.double()
    with pytest.raises((TypeError, ValueError)):
        pfb_fir_kernel(x, h)


@pytest.mark.parametrize("pool", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wideband_on_card_matches_cpu(cuda_device, pool, dtype):
    M = 8
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    wide_cfg = LoRaConfig(sf=7, cr=4, samp_rate=wide_rate, crc=True)
    sps_w = wide_cfg.samples_per_symbol
    rng = np.random.default_rng(2)
    x = 1e-3 * (rng.normal(size=(160 * sps_w, 2)) @ [1, 1j])
    freqs = pfb_channel_freqs(wide_rate, M)
    for c in (1, 3, 6):
        pkt = modulate_frame(wide_cfg, b"\xde\xad\xbe\xef" + bytes([c]), snr_db=None)
        pos = (8 + 3 * c) * sps_w
        t = np.arange(len(pkt)) + pos
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[c] / wide_rate * t)
    x = x.astype(np.complex64)
    kw = dict(pool=pool, plane_dtype=dtype, max_candidates=2, max_symbols=24,
              sfd_search=12, demod_method="fft")
    before = (pfb_fir_kernel.launches, detection_metrics_kernel.launches)
    got = WidebandReceiver(cfg, M, device=cuda_device, **kw).run(x)
    assert (pfb_fir_kernel.launches, detection_metrics_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    want = WidebandReceiver(cfg, M, device="cpu", **kw).run(x)
    assert sorted(f.channel for f in want) == [1, 3, 6]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.sample_index, g.phy_header.to_bytes(), g.payload,
                g.tap_header.frequency) == (w.channel, w.sample_index,
                                            w.phy_header.to_bytes(), w.payload,
                                            w.tap_header.frequency)
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


# C, sps_min, rows, tail samples, lags: the gateway's row and lag geometry,
# SF7-12 at 1 Msps with a ragged row count, lags (1, 3), sps off the 128
# grid, lags at and past R, one run of rows, lags past the staged halo,
# twelve lags (two register chunks)
LAG_GEOMS = [(4, 256, 1759, 247, (1, 2, 4, 8, 16, 32)), (3, 128, 1189, 17, (1, 2, 4, 8, 16, 32)),
             (3, 128, 111, 17, (1, 3)), (2, 100, 300, 0, (1, 2, 4)), (2, 1000, 50, 7, (1, 2, 8)),
             (2, 256, 20, 0, (1, 2, 20, 64)), (1, 128, 40, 0, (1, 2, 4, 8, 16, 32)),
             (2, 128, 150, 5, (1, 5, 70, 100)), (2, 64, 50, 0, tuple(range(1, 13)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,sps,rows,tail,lags", LAG_GEOMS)
def test_lag_rows_kernel_matches_plain(cuda_device, C, sps, rows, tail, lags, dtype):
    rng = np.random.default_rng(C + sps + rows)
    x = torch.from_numpy(rng.normal(size=(C, 2, rows * sps + tail)).astype(np.float32))
    x = x.to(cuda_device).to(dtype)
    before = lag_rows_kernel.launches
    e, qs = lag_rows_kernel(x, sps, lags)
    torch.cuda.synchronize()
    assert lag_rows_kernel.launches == before + 1
    e_w, qs_w = lag_rows_planes(x, sps, lags)
    assert e.shape == (C, rows) and e.is_cuda and e.dtype == torch.float32
    torch.testing.assert_close(e, e_w, rtol=1e-5, atol=0)
    for lag in lags:
        scale = torch.sqrt(e_w * torch.nn.functional.pad(e_w, (0, lag))[:, lag:lag + rows])
        for g, w in zip(qs[lag], qs_w[lag]):
            assert g.shape == (C, rows)
            assert bool(((g - w).abs() <= 1e-5 * scale).all())


# C, sps_min, rows, tail, lags, pitch past L, 16-byte copies: the
# gateway's view as the channelizer leaves it (pitch L + 1), a pitch off
# the 16-byte grid, sps = 4096 (column chunks) pitched and contiguous,
# lags past the staged rows on a pitched view, one row
PITCHED_LAG_GEOMS = [(4, 256, 1759, 247, (1, 2, 4, 8, 16, 32), 1, True),
                     (3, 128, 300, 17, (1, 2, 4, 8, 16, 32), 2, False),
                     (2, 4096, 20, 0, (1, 2, 4), 8, True), (2, 4096, 20, 5, (1, 2, 4), 0, False),
                     (2, 128, 150, 0, (1, 5, 70, 100), 8, True), (3, 256, 1, 0, (1,), 8, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,sps,rows,tail,lags,pad,vector", PITCHED_LAG_GEOMS)
def test_lag_rows_kernel_reads_pitched_planes(cuda_device, C, sps, rows, tail, lags, pad,
                                              vector, dtype):
    """A view of a longer buffer is read where it lies, through 16-byte
    copies where its pitch allows them, else scalar ones; two launches give
    bit-identical rows."""
    n = rows * sps + tail
    rng = np.random.default_rng(C + sps + rows + pad)
    buf = torch.from_numpy(rng.normal(size=(C, 2, n + pad)).astype(np.float32))
    x = buf.to(cuda_device).to(dtype)[..., :n]
    want_width = 16 // x.element_size() if vector else 1
    assert _lag_vector_width(x, sps) == want_width
    before = lag_rows_kernel.launches
    e, qs = lag_rows_kernel(x, sps, lags)
    again = lag_rows_kernel(x, sps, lags)
    torch.cuda.synchronize()
    assert lag_rows_kernel.launches == before + 2
    assert torch.equal(e, again[0])
    e_w, qs_w = lag_rows_planes(x, sps, lags)
    torch.testing.assert_close(e, e_w, rtol=1e-5, atol=0)
    for lag in lags:
        scale = torch.sqrt(e_w * torch.nn.functional.pad(e_w, (0, lag))[:, lag:lag + rows])
        for g, g2, w in zip(qs[lag], again[1][lag], qs_w[lag]):
            assert torch.equal(g, g2)
            assert bool(((g - w).abs() <= 1e-5 * scale).all())


def test_lag_rows_kernel_single_stream(cuda_device):
    x = torch.randn((2, 30 * 256 + 9), device=cuda_device)
    e, qs = lag_rows_kernel(x, 256, (2, 1))
    assert e.shape == (30,) and sorted(qs) == [1, 2]
    torch.testing.assert_close(e, lag_rows_planes(x, 256, (1,))[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["fp16", "three-planes", "strided", "meta-device", "lag-0"])
def test_lag_rows_kernel_refuses(cuda_device, case):
    x, lags = torch.zeros((2, 2, 4096), device=cuda_device), (1, 2)
    if case == "fp16":
        x = x.half()
    elif case == "three-planes":
        x = torch.zeros((2, 3, 4096), device=cuda_device)
    elif case == "strided":
        x = torch.zeros((2, 2, 8192), device=cuda_device)[..., ::2]
    elif case == "meta-device":
        x = torch.zeros((2, 2, 4096), device="meta")
    else:
        lags = (0, 1)
    before = lag_rows_kernel.launches
    with pytest.raises((TypeError, ValueError)):
        lag_rows_kernel(x, 256, lags)
    assert lag_rows_kernel.launches == before


GATEWAY_PLACEMENTS = [(7, 2), (8, 5), (9, 6)]


def _gateway_pair(cuda_device, shared):
    """tests/test_multi_sf.py:42-69's capture, SF7-9 on 8 channels, and
    the gateway on the card and on the CPU."""
    M = 8
    cfg = LoRaConfig(sf=7, cr=1, samp_rate=250e3, crc=True)
    wide_rate = M * cfg.samp_rate
    freqs = pfb_channel_freqs(wide_rate, M)
    kw = dict(sfs=(7, 8, 9), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
              demod_method="fft", shared_detection=shared)
    gpu = MultiSFWidebandReceiver(cfg, M, device=cuda_device, **kw)
    cpu = MultiSFWidebandReceiver(cfg, M, device="cpu", **kw)
    L = (32 * 1024 + 2 * cpu.max_pkt_samples) * M
    rng = np.random.default_rng(7)
    x = 1e-4 * (rng.normal(size=(L, 2)) @ [1, 1j])
    for sf, c in GATEWAY_PLACEMENTS:
        wcfg = LoRaConfig(sf=sf, cr=1, samp_rate=wide_rate, crc=True)
        pkt = modulate_frame(wcfg, bytes([sf, c]), snr_db=None)
        pos = 2 * wcfg.samples_per_symbol
        t = np.arange(pos, pos + len(pkt))
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * freqs[c] / wide_rate * t)
    return x.astype(np.complex64), gpu, cpu


def _frames_equal(got, want):
    assert [(f.tap_header.sf, f.channel, f.payload[:2]) for f in want] == \
        [(sf, c, bytes([sf, c])) for sf, c in GATEWAY_PLACEMENTS]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.sample_index, g.phy_header.to_bytes(), g.payload,
                g.tap_header.frequency, g.tap_header.sf) == \
            (w.channel, w.sample_index, w.phy_header.to_bytes(), w.payload,
             w.tap_header.frequency, w.tap_header.sf)
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


def test_gateway_hands_k3_the_channelizer_view(cuda_device, monkeypatch):
    """With shared detection the multi-lag kernel receives the
    channelizer's pitched view, not a copy, and the frames equal the
    CPU's."""
    from lora_tpu_torch.ops import cuda_kernels

    x, gpu, cpu = _gateway_pair(cuda_device, True)
    seen, k3 = [], cuda_kernels.lag_rows_kernel

    def spy(planes, *a):
        seen.append((planes.is_contiguous(), planes.stride(), tuple(planes.shape)))
        return k3(planes, *a)

    spy.launches = 0   # the wrapper counts on whatever its module's name holds
    monkeypatch.setattr(cuda_kernels, "lag_rows_kernel", spy)
    got = gpu.run(x)
    assert len(seen) == 1
    contiguous, stride, shape = seen[0]
    assert not contiguous and stride[-2] > shape[-1] and stride[-2] % 8 == 0
    _frames_equal(got, cpu.run(x))


@pytest.mark.parametrize("shared", [True, False])
def test_gateway_on_card_matches_cpu(cuda_device, shared):
    """tests/test_multi_sf.py:42-69's capture: SF7-9 on 8 channels."""
    x, gpu, cpu = _gateway_pair(cuda_device, shared)
    before = (pfb_fir_kernel.launches, lag_rows_kernel.launches,
              detection_metrics_kernel.launches)
    got = gpu.run(x)
    assert (pfb_fir_kernel.launches, lag_rows_kernel.launches,
            detection_metrics_kernel.launches) == \
        (before[0] + 1, before[1] + shared, before[2] + 3 * (not shared))
    _frames_equal(got, cpu.run(x))


def _fused_tables(C, D, ntaps, L, device):
    rate = D * 250e3
    offs = np.linspace(-0.4 * rate, 0.4 * rate, C)
    taps = np.random.default_rng(C + D).normal(0, 0.1, ntaps).astype(np.float32)
    return fused_tables(offs, rate, taps, D, L, device)


# C, D, taps, L: the EU868 and US915 plan shapes, a ragged L, C = 1, D = 1,
# and past the TPU kernel's gate (K = 151; 2DK = 2016)
FUSED_GEOMS = [(7, 8, 77, 3604480), (23, 32, 309, 14417920), (7, 8, 77, 100003),
               (1, 4, 19, 4429), (2, 1, 31, 3000), (2, 2, 301, 5000), (3, 16, 1001, 40000)]


def _check_fused(C, D, ntaps, L, device, view="pitch", path=None):
    """The kernel against its plain version on planes laid out as ``view``
    says: ``pitch`` a plane stride of L + 5, ``aligned`` 16-byte aligned
    planes and stride, ``offset`` the view ``x[:, 1:]``; with ``path``, the
    launch must count as that kernel (``chan.k5.<path>``) and only it."""
    g2, ramp, mix = _fused_tables(C, D, ntaps, L, device)
    if view == "pitch":
        x = torch.randn((2, L + 5), device=device)[:, :L]     # a plane stride past L
    elif view == "aligned":
        x = torch.randn((2, -(-L // 4) * 4 + 4), device=device)[:, :L]
    else:
        x = torch.randn((2, L + 1), device=device)[:, 1:]
    before, counts = fused_channelize_kernel.launches, tracing.counters()
    got = fused_channelize_kernel(x, g2, ramp, D, ntaps, mix)
    torch.cuda.synchronize()
    assert fused_channelize_kernel.launches == before + 1
    if path is not None:
        assert fused_chan_path(C, D, -(-ntaps // D), x.stride(0), x.data_ptr()) == path
        after = tracing.counters()
        assert {p: after[f"chan.k5.{p}"] - counts[f"chan.k5.{p}"]
                for p in ("wide", "narrow")} == {p: int(p == path) for p in ("wide", "narrow")}
    want = fused_channelize_planes(x, g2, ramp, D, ntaps, 1024)
    assert got.shape == want.shape == (C, 2, (L - ntaps) // D + 1) and got.is_contiguous()
    bound = 2 * (g2.shape[1] + 4) * 2.0 ** -24 * float(g2.abs().sum(1).max()) \
        * float(x.abs().max())
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("C,D,ntaps,L", FUSED_GEOMS)
def test_fused_chan_kernel_matches_plain(cuda_device, C, D, ntaps, L):
    _check_fused(C, D, ntaps, L, cuda_device)


# the benchmark cell's shape (64 channels, D = 64, 617 taps) on aligned
# planes (the wide kernel), on the view x[:, 1:] (the first kernel), and
# with a ragged L whose last run of rows is partial (wide); the US915 plan
# shape on aligned planes
@pytest.mark.parametrize("C,D,ntaps,L,view,path", [
    (64, 64, 617, 64 * 60000, "aligned", "wide"), (64, 64, 617, 64 * 60000, "offset", "narrow"),
    (64, 64, 617, 64 * 60000 + 37, "aligned", "wide"),
    (23, 32, 309, 14417920, "aligned", "wide")])
def test_fused_chan_kernel_paths(cuda_device, C, D, ntaps, L, view, path):
    _check_fused(C, D, ntaps, L, cuda_device, view, path)


def test_fused_chan_kernel_tap_limit(cuda_device):
    """The kernel needs 256 + K - 1 <= tile (1024): K = 769 (49 passes of
    16 tap rows, the last rows' ramp entries past the limit zero) runs,
    K = 770 is refused by the launcher."""
    _check_fused(2, 1, 769, 3000, cuda_device)
    g2, ramp, mix = _fused_tables(2, 1, 770, 3000, cuda_device)
    x = torch.zeros((2, 3000), device=cuda_device)
    before = fused_channelize_kernel.launches
    with pytest.raises(RuntimeError, match="fused_chan launch failed"):
        fused_channelize_kernel(x, g2, ramp, 1, 770, mix)
    assert fused_channelize_kernel.launches == before


@pytest.mark.parametrize("case", ["strided-rows", "g2-shape", "g2-on-cpu", "f64-ramp",
                                  "mix-shape", "mix-f64", "mix-on-cpu"])
def test_fused_chan_kernel_refuses(cuda_device, case):
    g2, ramp, mix = _fused_tables(3, 8, 77, 20000, cuda_device)
    x = torch.zeros((2, 20000), device=cuda_device)
    if case == "strided-rows":
        x = torch.zeros((2, 40000), device=cuda_device)[:, ::2]
    elif case == "g2-shape":
        g2 = g2[:, :-8]
    elif case == "g2-on-cpu":
        g2 = g2.cpu()
    elif case == "f64-ramp":
        ramp = (ramp[0].double(),) + ramp[1:]
    elif case == "mix-shape":
        mix = (mix[0][:-8], mix[1])
    elif case == "mix-f64":
        mix = (mix[0], mix[1].double())
    else:
        mix = (mix[0].cpu(), mix[1])
    before = fused_channelize_kernel.launches
    with pytest.raises((TypeError, ValueError)):
        fused_channelize_kernel(x, g2, ramp, 8, 77, mix)
    assert fused_channelize_kernel.launches == before


@pytest.mark.parametrize("fused", [True, False])
def test_plan_gateway_on_card_matches_cpu(cuda_device, fused):
    """tests/test_plans.py:24-60's capture: EU868 at 868.3 MHz, 2 Msps, one
    packet at SF7 and one at SF8."""
    center, rate = 868.3e6, 2e6
    kw = dict(sfs=(7, 8), pool=8, max_candidates=2, max_symbols=16, sfd_search=10,
              demod_method="fft", fused=fused)
    gpu = PlanGateway("EU868", center, rate, device=cuda_device, **kw)
    cpu = PlanGateway("EU868", center, rate, device="cpu", **kw)
    rng = np.random.default_rng(5)
    L = 40 * 4096
    x = rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)
    t = np.arange(L, dtype=np.float64)
    for sf, f_abs in ((7, 868.1e6), (8, 868.5e6)):
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, bytes([sf, 0x42]), snr_db=None)
        pos = 2 * wcfg.samples_per_symbol
        x[pos:pos + len(pkt)] += pkt * np.exp(2j * np.pi * (f_abs - center) / rate
                                              * t[pos:pos + len(pkt)])
    x = x.astype(np.complex64)
    before = (fused_channelize_kernel.launches, lag_rows_kernel.launches)
    got = gpu.run(x)
    assert (fused_channelize_kernel.launches, lag_rows_kernel.launches) == \
        (before[0] + fused, before[1] + 1)
    want = cpu.run(x)
    assert [(f.tap_header.sf, f.tap_header.frequency, f.payload[:2]) for f in want] == \
        [(7, 868100000, bytes([7, 0x42])), (8, 868500000, bytes([8, 0x42]))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.channel, g.sample_index, g.phy_header.to_bytes(), g.payload,
                g.tap_header.frequency, g.tap_header.sf) == \
            (w.channel, w.sample_index, w.phy_header.to_bytes(), w.payload,
             w.tap_header.frequency, w.tap_header.sf)
        assert g.snr == pytest.approx(w.snr, rel=1e-4)
        assert g.cfo == pytest.approx(w.cfo, abs=1.0)


def _stream_capture(cfg, n_packets, seed):
    """Packets of ``cfg`` at 40 dB, 30-60 symbols apart (tests/test_stream.py's stream)."""
    rng = np.random.default_rng(seed)
    sps = cfg.samples_per_symbol
    parts = []
    for i in range(n_packets):
        parts.append(np.zeros(int(rng.integers(30, 60)) * sps, np.complex64))
        parts.append(modulate_frame(cfg, bytes([i, 0xA5, i ^ 0xFF]), snr_db=40.0, seed=seed + i))
    parts.append(np.zeros(32 * sps, np.complex64))
    return np.concatenate(parts)


def _streamed(sr, x, chunk):
    frames = []
    for off in range(0, len(x), chunk):
        frames += sr.push(x[off:off + chunk])
    frames += sr.flush()
    sr.close()
    return [(f.sample_index, f.payload, f.phy_header.to_bytes(), round(f.cfo, 1)) for f in frames]


def test_stream_blocks_in_flight_match_one_at_a_time(cuda_device):
    """``max_in_flight=3`` with tiny blocks, all pushed at once so the pump
    queues block after block, gives the frames of ``max_in_flight=1`` and
    of the CPU: a staging slot refilled while its copy is in flight would
    corrupt a block on the card."""
    from lora_tpu_torch.stream import StreamingReceiver

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3, crc=True)
    x = _stream_capture(cfg, 12, seed=21)
    out = {}
    for dev, mif in ((cuda_device, 3), (cuda_device, 1), ("cpu", 1)):
        rx = DenseReceiver(cfg, max_candidates=8, max_symbols=24, sfd_search=12,
                           demod_method="fft", device=dev)
        sr = StreamingReceiver(rx, block_symbols=64, max_in_flight=mif)
        if sr._stager.device.type == "cuda":
            assert all(s.is_pinned() for s in sr._stager._slots)
            assert len(sr._stager._slots) == mif + 1
        out[(str(dev), mif)] = _streamed(sr, x, len(x))
    got, serial, cpu = out.values()
    assert len(got) == 12
    assert got == serial
    assert [g[:3] for g in got] == [c[:3] for c in cpu]


def test_plan_stream_on_card_matches_cpu(cuda_device):
    """The plan gateway streamed on the card and on the CPU (EU868 at 1 Msps,
    tests/test_plan_stream.py's capture): the same frames."""
    from lora_tpu_torch.stream import WidebandStreamingReceiver

    center, rate = 867.3e6, 1e6
    sps8 = int(2 ** 8 * rate / 125e3)
    L = 3 * 96 * sps8
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 1e-4, L) + 1j * rng.normal(0, 1e-4, L)).astype(np.complex64)
    t = np.arange(L, dtype=np.float64)
    for sf, f_abs, pos in ((7, 867.1e6, 2 * sps8), (8, 867.5e6, 90 * sps8),
                           (7, 867.3e6, 150 * sps8)):
        wcfg = LoRaConfig(sf=sf, cr=4, samp_rate=rate, crc=True, sync_word=0x34)
        pkt = modulate_frame(wcfg, bytes([sf, 0x42]), snr_db=None)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * (f_abs - center) / rate
                                               * t[pos:pos + len(pkt)])).astype(np.complex64)
    out = {}
    for dev in (cuda_device, "cpu"):
        gw = PlanGateway("EU868", center, rate, sfs=(7, 8), pool=8, max_candidates=2,
                         max_symbols=16, sfd_search=10, demod_method="fft", device=dev)
        sr = WidebandStreamingReceiver(gw, block_symbols=96, max_in_flight=2)
        frames = []
        for off in range(0, len(x), 100_003):
            frames += sr.push(x[off:off + 100_003])
        frames += sr.flush()
        sr.close()
        out[str(dev)] = [(f.channel, f.tap_header.sf, f.sample_index, f.payload) for f in frames]
    assert len(out["cpu"]) == 3
    assert out[str(cuda_device)] == out["cpu"]


# ------------------------------------- the facade, implicit, low_snr, debug
def _frames_equal(fg, fc):
    """Card against CPU: header bytes, payload, channel, sample index and
    frequency equal; cfo within 2 Hz, snr rtol 1e-4 (as chip_smoke.py)."""
    assert len(fg) == len(fc) > 0
    for a, b in zip(fg, fc):
        assert (a.phy_header.to_bytes(), a.payload, a.channel, a.sample_index,
                a.tap_header.frequency) == (b.phy_header.to_bytes(), b.payload, b.channel,
                                            b.sample_index, b.tap_header.frequency)
        assert abs(a.cfo - b.cfo) <= 2.0 and abs(a.snr - b.snr) <= 1e-4 * abs(b.snr)


@pytest.mark.parametrize("n_ch", [1, 3])
def test_facade_on_card_matches_cpu(cuda_device, n_ch):
    """The dense facade at SF7, 1 Msps, decimation 4 (the fft engine):
    every packet, one K1 launch a receive(), the CPU's frames."""
    from lora_tpu_torch import LoRaReceiver

    offs = (-300e3, 0.0, 250e3)
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    rng = np.random.default_rng(n_ch)
    L = 300_000
    x = (0.02 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    for c, off in enumerate(offs):
        pkt = modulate_frame(cfg, bytes([0xF0 + c]) + bytes.fromhex("deadbeef"), snr_db=None,
                             seed=c)
        pos = 10_000 + 60_000 * c
        t = np.arange(pos, pos + len(pkt), dtype=np.float64)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * off / 1e6 * t)).astype(np.complex64)
    kw = dict(samp_rate=1e6, center_freq=868.1e6,
              channel_list=[868.1e6 + o for o in offs[:n_ch]], bandwidth=125e3, sf=7,
              decimation=4, engine="dense", max_candidates=4, max_symbols=24)
    rx = LoRaReceiver(**kw)
    assert rx.device.type == "cuda"
    before = detection_metrics_kernel.launches
    frames = rx.receive(x)
    assert detection_metrics_kernel.launches == before + 1
    assert sorted(f.channel for f in frames) == list(range(n_ch))
    _frames_equal(frames, LoRaReceiver(device="cpu", **kw).receive(x))


@pytest.mark.parametrize("method,rate", [("fft", 250e3), ("gradient", 1e6)])
@pytest.mark.parametrize("cr", [1, 4])
def test_implicit_on_card_matches_cpu(cuda_device, method, rate, cr):
    cfg = LoRaConfig(sf=7, cr=cr, samp_rate=rate, crc=False, implicit=True)
    sps = cfg.samples_per_symbol
    x = modulate_frame(cfg, b"\xca\xfe\x01\x02", pad_before=4 * sps, pad_after=8 * sps,
                       snr_db=40.0, seed=cr)
    kw = dict(demod_method=method, max_candidates=2, max_symbols=24)
    frames = DenseReceiver(cfg, **kw).run(x)
    assert frames[0].payload[:4] == b"\xca\xfe\x01\x02"
    _frames_equal(frames, DenseReceiver(cfg, **kw, device="cpu").run(x))


@pytest.mark.parametrize("kw,snr", [(dict(sf=7, cr=4, samp_rate=250e3, crc=True), -4.0),
                                    (dict(sf=12, cr=4, samp_rate=250e3, crc=True,
                                          reduced_rate=True), -16.0)],
                         ids=["sf7", "sf12-64M-budget"])
def test_low_snr_on_card_matches_cpu(cuda_device, kw, snr):
    cfg = LoRaConfig(**kw)
    x = modulate_frame(cfg, bytes.fromhex("deadbeef"), pad_before=2500,
                       pad_after=3 * cfg.samples_per_symbol, snr_db=snr, seed=1)
    rkw = dict(max_candidates=8, max_symbols=24, sfd_search=12, low_snr=True)
    before = detection_metrics_kernel.launches
    frames = DenseReceiver(cfg, **rkw).run(x)
    assert detection_metrics_kernel.launches == before     # the dechirp metric: no kernel
    assert [f.mac_payload for f in frames] == [bytes.fromhex("deadbeef")]
    _frames_equal(frames, DenseReceiver(cfg, **rkw, device="cpu").run(x))


@pytest.mark.parametrize("method", ["gradient", "fft"])
def test_debug_trace_on_card_matches_cpu(cuda_device, method):
    """Integer and boolean keys equal; float keys rtol 1e-5, atol 1e-6 of
    the key's largest magnitude (K1's ``corr`` atol 2e-5)."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    x = modulate_frame(cfg, bytes.fromhex("deadbeef"), pad_before=3000,
                       pad_after=2 * cfg.samples_per_symbol, snr_db=30.0, seed=5)
    kw = dict(demod_method=method, max_candidates=2, max_symbols=24)
    got = DenseReceiver(cfg, **kw).debug_trace(x)
    want = DenseReceiver(cfg, **kw, device="cpu").debug_trace(x)
    assert sorted(got) == sorted(want) and got["ok"].any()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.floating):
            atol = 2e-5 if k == "corr" else 1e-6 * np.abs(w).max()
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _parity_streams():
    """Three SF7 streams of one length: 1, 2 and 3 frames, each at its own
    offset."""
    cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True)
    sps = cfg.samples_per_symbol
    streams = []
    for c in range(3):
        one = modulate_frame(cfg, bytes([0xA0 + c]) + bytes.fromhex("deadbeef"),
                             pad_before=2500 + 1000 * c, pad_after=2 * sps, snr_db=40.0, seed=c)
        streams.append(np.concatenate([one] * (1 + c)))
    L = max(len(s) for s in streams) + 4 * sps
    return cfg, np.stack([np.pad(s, (0, L - len(s))) for s in streams])


@pytest.mark.parametrize("case", ["one-stream", "three-channel-batch", "clamp-state"])
def test_parity_on_card_matches_cpu(cuda_device, case):
    """The parity engine on the card against the CPU: frames (header,
    payload, channel, sample index exact; snr rtol 1e-4), and for the
    implicit capture that runs past the demod buffer, the final state
    (integer fields equal, float fields rtol 1e-4)."""
    from lora_tpu_torch import ParityReceiver

    if case == "clamp-state":
        cfg = LoRaConfig(sf=7, cr=4, samp_rate=1e6, crc=True, implicit=True)
        pkt = modulate_frame(cfg, bytes.fromhex("deadbeef"), pad_before=2500, snr_db=None)
        rng = np.random.default_rng(0)
        n = 700 * cfg.samples_per_symbol
        x = torch.from_numpy(np.concatenate([pkt, (rng.normal(size=n) + 1j * rng.normal(
            size=n)).astype(np.complex64)]))[None]
        got = ParityReceiver(cfg).process_complex(x.cuda())
        want = ParityReceiver(cfg, device="cpu").process_complex(x)
        assert int(want["n_demod"][0]) == 544
        for k, w in want.items():
            if w.is_floating_point():
                torch.testing.assert_close(got[k].cpu(), w, rtol=1e-4, atol=0)
            else:
                assert torch.equal(got[k].cpu(), w), k
        return
    cfg, streams = _parity_streams()
    rx, cpu = ParityReceiver(cfg), ParityReceiver(cfg, device="cpu")
    assert rx.device.type == "cuda"
    if case == "one-stream":
        got, want = rx.run(streams[2]), cpu.run(streams[2])
        assert len(got) == 3
    else:
        got, want = rx.run_batch(streams), cpu.run_batch(streams)
        assert [f.channel for f in got] == [0, 1, 1, 2, 2, 2]
    assert rx.state_reads == rx.steps + 1
    _frames_equal(got, want)


def _route_graph(route):
    """A receiver block and a capture for each channelizer route: the
    mixer bank (three channels at decimation 2), the one-channel FIR
    (decimation 4) and the PFB grid (M = 8, three channels)."""
    from lora_tpu_torch.flowgraph import StreamingLoRaReceiver

    rate = 2e6 if route != "fir" else 1e6
    offs = {"mixer_bank": (-300e3, 130e3, 610e3), "fir": (50e3,),
            "pfb": (-500e3, 250e3, 750e3)}[route]
    D = {"mixer_bank": 2, "fir": 4, "pfb": 8}[route]
    wide = LoRaConfig(sf=7, cr=4, samp_rate=rate, crc=True)
    rng = np.random.default_rng(5)
    L = 60 * wide.samples_per_symbol * len(offs) + 400_000
    # noise of 0.02 a part: above the other channels' leakage through the
    # channel filter (a scale-invariant detector raises candidates on it)
    x = (0.02 * (rng.normal(size=L) + 1j * rng.normal(size=L))).astype(np.complex64)
    for c, off in enumerate(offs):
        pkt = modulate_frame(wide, bytes([0xD0 + c, 0x01]), snr_db=None, seed=c)
        pos = 5000 + 40 * wide.samples_per_symbol * c
        t = np.arange(pos, pos + len(pkt), dtype=np.float64)
        x[pos:pos + len(pkt)] += (pkt * np.exp(2j * np.pi * off / rate * t)).astype(np.complex64)

    def make(device):
        return StreamingLoRaReceiver(rate, 868e6, [868e6 + o for o in offs], sf=7, cr=4,
                                     decimation=D, block_symbols=128, max_candidates=4,
                                     max_symbols=24, device=device)
    return make, x, len(offs)


@pytest.mark.parametrize("route", ["mixer_bank", "fir", "pfb"])
def test_flowgraph_route_on_card_matches_cpu(cuda_device, route):
    """One graph receiver of each channelizer route on the card against the
    CPU, the capture pushed in 100,003-sample chunks: every packet, the
    CPU's frames."""
    make, x, n = _route_graph(route)
    out = []
    for rx in (make(None), make("cpu")):
        assert rx.route == route
        frames = []
        for i in range(0, len(x), 100_003):
            frames += rx.push(x[i:i + 100_003])
        frames += rx.flush()
        rx.close()
        out.append(sorted(frames, key=lambda f: (f.channel, f.sample_index)))
    assert [f.payload[:2] for f in out[0]] == [bytes([0xD0 + c, 0x01]) for c in range(n)]
    _frames_equal(*out)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["dense", "parity"])
def test_suite_matrix_on_card(cuda_device, tmp_path, engine):
    """The 13 suites of the JAX package's accuracy matrix (its dense and
    parity columns, docs/test-results/README.md), generated by the port
    and run by its ``engine`` on the card: each at 100 %. Reports and the
    engine's index go to ``$LORA_TORCH_REPORTS`` when set (else a
    temporary directory)."""
    import os

    from lora_tpu_torch.tools.suite_matrix import MATRIX, run_matrix

    reports = os.environ.get("LORA_TORCH_REPORTS", str(tmp_path / "reports"))
    rows = run_matrix(reports=reports, engine=engine, device="cuda")
    assert [r["suite"] for r in rows] == [s for s, _ in MATRIX]
    assert all(r["passed"] == r["total"] > 0 for r in rows), rows


# ------------------------------------------------------------- sharding
@pytest.mark.parametrize("case", ["channel", "time", "wideband time", "subband"])
def test_sharded_on_card_matches_cpu_mesh(cuda_device, case):
    """The function on a 4-shard in-process mesh of the one card against
    the same mesh of CPU shards: integers and valid payloads bit-equal,
    ``snr`` rtol 1e-4 (2e-4 through the two filterbanks of the subband
    path), ``cfo`` atol 1 Hz; a packet decodes on each."""
    from lora_tpu_torch.parallel import make_mesh

    make, obj, x = sharding_cases(cuda_device)[case]
    _, cpu_obj, _ = sharding_cases("cpu")[case]
    got = make(obj, make_mesh(devices=["cuda:0"] * 4))(x.to(cuda_device))
    want = make(cpu_obj, make_mesh(devices=["cpu"] * 4))(x)
    assert got.valid.is_cuda and int(want.valid.sum()) > 0
    same_sharded(got, want, 2e-4 if case == "subband" else 1e-4)


@pytest.mark.parametrize("case", ["channel", "time", "wideband time", "subband"])
def test_cpu_receiver_on_card_mesh_matches_card_receiver(cuda_device, case):
    """A receiver built on the CPU, on a 4-shard mesh of the card: the
    shards decode with a replica built on the card from its ``init_args``,
    bit-equal on every field to the same mesh with a receiver built on the
    card."""
    from lora_tpu_torch.parallel import make_mesh
    from lora_tpu_torch.parallel.sharding import _placed

    make, obj, x = sharding_cases(cuda_device)[case]
    _, cpu_obj, _ = sharding_cases("cpu")[case]
    mesh = make_mesh(devices=["cuda:0"] * 4)
    replica = _placed(cpu_obj, mesh)[mesh.devices[0]]
    assert replica is not cpu_obj and replica.device == mesh.devices[0]
    xd = x.to(cuda_device)
    got, want = make(cpu_obj, mesh)(xd), make(obj, mesh)(xd)
    assert got.valid.is_cuda and int(want.valid.sum()) > 0
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_nccl_world_size_one_matches_in_process_mesh(cuda_device):
    """An NCCL group of one rank (every transfer a local copy): each
    function bit-equal to the in-process one-shard mesh on the card."""
    import torch.distributed as dist

    from lora_tpu_torch.parallel import make_mesh

    cases = sharding_cases(cuda_device)
    want = {k: make(obj, make_mesh(devices=["cuda:0"]))(x) for k, (make, obj, x) in cases.items()}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(group=dist.group.WORLD)
        assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),)
        for k, (make, obj, x) in cases.items():
            got = make(obj, mesh)(x)
            for f in got._fields:
                assert torch.equal(getattr(got, f), getattr(want[k], f)), (k, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- bench
BENCH_SMALL = {
    "dense": ("main", dict(n_channels=2, block_symbols=128)),
    "wideband": ("main_wideband", dict(n_channels=16)),
    "full occupancy": ("main_wideband_full", dict(n_channels=16)),
    "gateway": ("main_gateway", dict(n_channels=8, sfs=(7, 8))),
    "plan EU868": ("main_plan_gateway", dict(plan="EU868", sfs=(7, 8))),
    "plan US915": ("main_plan_gateway", dict(plan="US915", sfs=(7, 8))),
}


@pytest.mark.parametrize("stage", sorted(BENCH_SMALL))
def test_bench_stage_on_card_matches_cpu(cuda_device, stage):
    """Each ``lora_tpu_torch.bench`` stage at a small size (one round of one
    call), its capture upconverted on the card: both gates pass, and the
    gated calls decode the same lanes (channel, start, payload; and SF) as
    the same stage on the CPU, with the same metric names and ratios."""
    from lora_tpu_torch import bench

    name, kw = BENCH_SMALL[stage]
    fn = getattr(bench, name)
    got = fn(**kw, rounds=1, iters=1, device=cuda_device)
    want = fn(**kw, rounds=1, iters=1, device="cpu")
    assert got.lanes == want.lanes and all(len(lanes) > 0 for lanes in got.lanes)
    keys = [{k: v for k, v in r.items() if k not in ("value", "vs_baseline")} for r in want.lines]
    assert [{k: v for k, v in r.items() if k not in ("value", "vs_baseline")}
            for r in got.lines] == keys
