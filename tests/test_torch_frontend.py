"""The port's detection frontend against lora_tpu's.

The detection metric (the plain version of the CUDA kernel, and the
kernel wrapper's CPU dispatch) against the Pallas kernel in interpret mode
and the XLA planes math, float32 and bfloat16 planes: corr atol 2e-5,
energies rtol 1e-5 (float32 sums taken in another order). Candidate
extraction and leak suppression bit-equal on the JAX metrics. The kernel
against its plain version on the card where there is one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lora_tpu.ops.pallas_kernels import detection_metrics_pallas
from lora_tpu.rx import frontend as jfront

from lora_tpu_torch.ops.cuda_kernels import detection_metrics_kernel
from lora_tpu_torch.rx import frontend

GEOMS = [(1024, 64, 0), (8192, 16, 0), (1024, 37, 341)]  # sps, windows, tail


def _planes(sps, k1, tail, seed=0):
    rng = np.random.default_rng(seed + sps + k1)
    return rng.normal(size=(2, 2, k1 * sps + tail)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


def _np(metrics):
    return [np.asarray(m, dtype=np.float32) for m in metrics]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sps,k1,tail", GEOMS)
def test_metrics_match_pallas_and_planes(sps, k1, tail, dtype):
    x = _planes(sps, k1, tail)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
        xj = xj.astype(jnp.bfloat16)
        # both round to nearest even: the two inputs hold the same values
        np.testing.assert_array_equal(xt.float().numpy(),
                                      np.asarray(xj.astype(jnp.float32)))
    pallas = _np(detection_metrics_pallas(xj, sps, interpret=True))
    planes = _np(jfront.detection_metrics_planes(xj, sps))
    plain = _np(frontend.detection_metrics_planes(xt, sps))
    wrapped = _np(detection_metrics_kernel(xt, sps))
    K = (k1 * sps + tail) // sps - 1
    for m in plain + wrapped:
        assert m.shape == (2, K) and m.dtype == np.float32
    for got in (plain, wrapped):
        _close(got, pallas)
        _close(got, planes)


def _metrics_from_jax(seed):
    """JAX metrics of a 4-channel block with preambles on two channels and
    one channel carrying a 40 dB-weaker copy (the sidelobe-leak case)."""
    from lora_tpu import LoRaConfig
    from lora_tpu.tx.modulator import modulate_frame

    cfg = LoRaConfig(sf=7, cr=4, samp_rate=250e3)
    sps = cfg.samples_per_symbol
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 300 * sps)) + 1j * rng.normal(size=(4, 300 * sps)))
    x = (0.01 * x).astype(np.complex64)
    pkt = modulate_frame(cfg, b"\x01\x02\x03")
    for c, s0 in ((0, 7 * sps + 3), (1, 40 * sps), (1, 150 * sps + 77)):
        x[c, s0:s0 + len(pkt)] += pkt
    x[2, 7 * sps + 3: 7 * sps + 3 + len(pkt)] += 0.01 * pkt
    xf = np.stack([x.real, x.imag], axis=-2).astype(np.float32)
    return [np.array(m) for m in jfront.detection_metrics_planes(jnp.asarray(xf), sps)]


@pytest.mark.parametrize("P", [1, 2, 8])
def test_candidates_and_leak_mask_bit_equal(P):
    corr, e1, _ = _metrics_from_jax(seed=P)
    sup_j = np.asarray(jfront.leak_suppression(jnp.asarray(e1)))
    sup_t = frontend.leak_suppression(torch.from_numpy(e1)).numpy()
    np.testing.assert_array_equal(sup_t, sup_j)
    assert sup_t[2].any()  # the weak copy is masked
    want = jfront.candidate_starts(jnp.asarray(corr), 0.9, P,
                                   suppress=jnp.asarray(sup_j))
    got = frontend.candidate_starts(torch.from_numpy(corr), 0.9, P,
                                    suppress=torch.from_numpy(sup_t))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].any()


@pytest.mark.parametrize("seed", range(4))
def test_candidates_bit_equal_on_random_metrics(seed):
    rng = np.random.default_rng(seed)
    corr = rng.uniform(0.5, 1.0, (3, 200)).astype(np.float32)
    e1 = (rng.uniform(0, 1, (3, 200)) * 10.0 ** rng.integers(-5, 2, (3, 1))).astype(np.float32)
    for lead in (slice(None), 0):  # [C, K] and a single stream [K]
        c, e = corr[lead], e1[lead]
        sup_j = np.asarray(jfront.leak_suppression(jnp.asarray(e)))
        sup_t = frontend.leak_suppression(torch.from_numpy(np.ascontiguousarray(e)))
        np.testing.assert_array_equal(sup_t.numpy(), sup_j)
        want = jfront.candidate_starts(jnp.asarray(c), 0.8, 5, suppress=jnp.asarray(sup_j))
        got = frontend.candidate_starts(torch.from_numpy(np.ascontiguousarray(c)), 0.8, 5,
                                        suppress=sup_t)
        for g, w in zip(got, want):
            assert g.dtype in (torch.int32, torch.bool)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
