"""The port on the card: each kernel against its plain torch version, and
the dense receiver on the card against the port on the CPU.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: corr atol 2e-5, energies rtol 1e-5 (float32 sums in another
order); receiver results as in test_torch_dense.py."""

import numpy as np
import pytest
import torch

from lora_tpu_torch import DenseReceiver, LoRaConfig
from lora_tpu_torch.ops.cuda_kernels import (detection_metrics_kernel,
                                             detection_metrics_planes)
from lora_tpu_torch.ops.xfer import pack_iq
from lora_tpu_torch.tx.modulator import modulate_frame

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
