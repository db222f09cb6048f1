"""Wrappers of the port's hand-written CUDA kernels.

:func:`detection_metrics_kernel` launches ``csrc/det_metrics.cu`` (the
Hopper counterpart of the TPU kernel ``_det_kernel_pp``) for a CUDA
tensor, and takes its plain torch version,
:func:`detection_metrics_planes`, re-exported here, only for a tensor on
the CPU. On a CUDA tensor it launches the kernel or raises: nothing falls
back. ``detection_metrics_kernel.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..rx.frontend import detection_metrics_planes  # noqa: F401  (plain version)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _det_lib():
    from ._build import load

    lib = load("det_metrics")
    lib.det_metrics_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.det_metrics_launch.restype = ctypes.c_int
    lib.det_metrics_error_string.argtypes = [ctypes.c_int]
    lib.det_metrics_error_string.restype = ctypes.c_char_p
    return lib


def detection_metrics_kernel(xf: torch.Tensor, sps: int):
    """Detection metrics of packed IQ ``[..., 2, L]`` (float32 or
    bfloat16): ``(corr, e1, e2)`` float32 ``[..., K]``, ``K = L//sps - 1``,
    as :func:`detection_metrics_planes` computes them.

    CPU tensor: the plain version. CUDA tensor: the kernel; it must be
    contiguous. Raises on any other dtype, layout or device, and when the
    block holds fewer than two symbol windows.
    """
    if not isinstance(xf, torch.Tensor):
        raise TypeError("detection_metrics_kernel takes a torch tensor")
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"packed planes must be float32 or bfloat16, not {xf.dtype}")
    if xf.ndim < 2 or xf.shape[-2] != 2:
        raise ValueError(f"expected packed planes [..., 2, L], got {tuple(xf.shape)}")
    sps = int(sps)
    L = xf.shape[-1]
    if sps < 1 or L // sps < 2:
        raise ValueError(f"need at least two windows of {sps} samples, got L={L}")
    if xf.device.type == "cpu":
        return detection_metrics_planes(xf, sps)
    if xf.device.type != "cuda":
        raise ValueError(f"no detection kernel for device {xf.device}")
    if not xf.is_contiguous():
        raise ValueError("the detection kernel reads contiguous planes")
    lead = xf.shape[:-2]
    C = math.prod(lead)
    K1 = L // sps
    K = K1 - 1
    corr = torch.empty((C, K), dtype=torch.float32, device=xf.device)
    ener = torch.empty((C, K1), dtype=torch.float32, device=xf.device)
    lib = _det_lib()
    with torch.cuda.device(xf.device):  # the C entry launches on the current device
        rc = lib.det_metrics_launch(
            xf.data_ptr(), corr.data_ptr(), ener.data_ptr(), C, L, sps,
            _DTYPE_CODE[xf.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.det_metrics_error_string(rc).decode()
        raise RuntimeError(f"det_metrics launch failed: {msg} ({rc})")
    detection_metrics_kernel.launches += 1
    return (corr.reshape(lead + (K,)), ener[:, :K].reshape(lead + (K,)),
            ener[:, 1:].reshape(lead + (K,)))


detection_metrics_kernel.launches = 0
