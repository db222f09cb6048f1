"""The detection metric's variants and its window-major form against
lora_tpu's, on the same numpy inputs.

- ``detection_metrics_kernel(variant=...)`` (the "pp" kernel K1 and the
  staged "tile" kernel K2; on the CPU their plain version) against JAX's
  ``detection_metrics_pallas(..., interpret=True, variant=...)``, the
  Pallas kernels run in interpret mode.
- ``detection_metrics_wm_planes``, the plain version of the window-major
  kernel K6, against the Pallas ``det_wm`` of ``tools/profile_packing.py``
  (loaded by path, run in TPU interpret mode on the CPU), last column
  included.

Tolerances as tests/test_pallas_kernels.py: corr atol 2e-5, energies
rtol 1e-5 (float32 sums in another order)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lora_tpu.ops.pallas_kernels import detection_metrics_pallas

from lora_tpu_torch.ops.cuda_kernels import (DET_VARIANTS, detection_metrics_kernel,
                                             detection_metrics_planes,
                                             detection_metrics_tile_kernel,
                                             detection_metrics_wm_kernel,
                                             detection_metrics_wm_planes)

ROOT = Path(__file__).resolve().parent.parent


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=0, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=0)


# (sps, k1, tail samples): the JAX test's geometries, and a ragged window
# count (JAX runs its tail through the planes math)
@pytest.mark.parametrize("variant", DET_VARIANTS)
@pytest.mark.parametrize("sps,k1,tail", [(1024, 64, 0), (8192, 16, 0), (1024, 37, 341)])
def test_variant_matches_jax(sps, k1, tail, variant):
    rng = np.random.default_rng(sps + k1)
    x = rng.normal(size=(2, 2, k1 * sps + tail)).astype(np.float32)
    want = detection_metrics_pallas(jnp.asarray(x), sps, interpret=True, variant=variant)
    got = detection_metrics_kernel(torch.from_numpy(x), sps, variant=variant)
    assert all(g.dtype == torch.float32 and g.shape == (2, k1 - 1) for g in got)
    _close([g.numpy() for g in got], want)


def test_tile_bf16_planes_match_jax():
    # the tile variant takes float32: bf16 planes are upcast first, in both
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 2, 32 * 1024)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)   # the same values
    want = detection_metrics_pallas(xj, 1024, interpret=True, variant="tile")
    got = detection_metrics_kernel(xt, 1024, variant="tile")
    _close([g.numpy() for g in got], want)
    _close([g.numpy() for g in got],
           [g.numpy() for g in detection_metrics_planes(xt.float(), 1024)])


def test_tile_wrapper_counts_no_cpu_launch():
    x = torch.zeros((1, 2, 4 * 256))
    before = detection_metrics_tile_kernel.launches, detection_metrics_kernel.launches
    detection_metrics_kernel(x, 256, variant="tile")
    detection_metrics_kernel(x, 256)
    assert (detection_metrics_tile_kernel.launches, detection_metrics_kernel.launches) == before


@pytest.mark.parametrize("variant", ["", "PP", "wm", None])
def test_unknown_variant_raises(variant):
    # before any other check: even a tensor no variant would take
    with pytest.raises(ValueError, match="variant"):
        detection_metrics_kernel(torch.zeros((1, 2, 1024)), 256, variant=variant)
    with pytest.raises(ValueError, match="variant"):
        detection_metrics_kernel("not a tensor", 256, variant=variant)


def _jax_det_wm():
    spec = importlib.util.spec_from_file_location("profile_packing",
                                                  ROOT / "tools" / "profile_packing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.det_wm


@pytest.mark.parametrize("C,K1,sps,T", [(2, 256, 128, 128), (1, 16, 256, 8)])
def test_wm_plain_matches_jax_det_wm(C, K1, sps, T):
    det_wm = _jax_det_wm()
    rng = np.random.default_rng(K1)
    xw = rng.normal(size=(C, K1, 2, sps)).astype(np.float32)
    xw[0, 3] = 0.0      # a silent window: corr 0 on both sides of it
    with pltpu.force_tpu_interpret_mode():
        cw, ew = jax.device_get(det_wm(jnp.asarray(xw), T))
    corr, ener = detection_metrics_wm_planes(torch.from_numpy(xw))
    assert corr.shape == ener.shape == (C, K1)
    _close([corr.numpy(), ener.numpy()], [cw, ew])
    # the last window is paired with itself
    np.testing.assert_allclose(corr[:, -1].numpy(), 1.0, atol=1e-6)
    assert corr[0, 2] == corr[0, 3] == 0.0


def test_wm_plain_matches_planes_metric():
    # the same metric as the plane-major one on the first K = K1 - 1 windows
    rng = np.random.default_rng(2)
    C, K1, sps = 3, 19, 100
    x = rng.normal(size=(C, 2, K1 * sps)).astype(np.float32)
    xw = torch.from_numpy(x).reshape(C, 2, K1, sps).permute(0, 2, 1, 3).contiguous()
    corr, ener = detection_metrics_wm_kernel(xw)
    c0, e1, e2 = detection_metrics_planes(torch.from_numpy(x), sps)
    _close([corr[:, :-1], ener[:, :-1], ener[:, 1:]], [c0, e1, e2])


def test_wm_wrapper_single_stream_and_refusals():
    rng = np.random.default_rng(3)
    xw = torch.from_numpy(rng.normal(size=(5, 2, 64)).astype(np.float32))
    before = detection_metrics_wm_kernel.launches
    corr, ener = detection_metrics_wm_kernel(xw)
    assert detection_metrics_wm_kernel.launches == before
    assert corr.shape == ener.shape == (5,)
    for g, w in zip((corr, ener), detection_metrics_wm_planes(xw)):
        assert torch.equal(g, w)
    one = detection_metrics_wm_kernel(xw[:1])       # one window: paired with itself
    assert float(one[0][0]) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(TypeError):
        detection_metrics_wm_kernel(xw.to(torch.bfloat16))
    with pytest.raises(ValueError):
        detection_metrics_wm_kernel(torch.zeros((4, 3, 64)))
    with pytest.raises(TypeError):
        detection_metrics_wm_kernel(xw.numpy())
