"""Wrappers of the port's hand-written CUDA kernels.

- :func:`detection_metrics_kernel` launches ``csrc/det_metrics.cu`` (the
  Hopper counterpart of the TPU kernel ``_det_kernel_pp``), or with
  ``variant="tile"`` :func:`detection_metrics_tile_kernel`, which launches
  ``csrc/det_tile.cu`` (the counterpart of ``_det_kernel``); the plain
  torch version of both is :func:`detection_metrics_planes`.
- :func:`detection_metrics_wm_kernel` launches ``csrc/det_wm.cu`` (the
  counterpart of ``_det_kernel_wm``, on window-major IQ); its plain
  version is :func:`detection_metrics_wm_planes`.
- :func:`pfb_fir_kernel` launches ``csrc/pfb_fir.cu`` (the counterpart of
  ``_pfb_fir_kernel``); its plain version is :func:`pfb_fir_planes`.
- :func:`lag_rows_kernel` launches ``csrc/lag_rows.cu`` (the counterpart
  of ``_lag_rows_kernel``); its plain version is :func:`lag_rows_planes`.
- :func:`fused_channelize_kernel` launches ``csrc/fused_chan.cu`` (the
  counterpart of ``_fused_chan_kernel``); its plain version is
  :func:`fused_channelize_planes`.

Each wrapper takes its plain version (re-exported here) only for a tensor
on the CPU. On a CUDA tensor it launches the kernel or raises: nothing
falls back. ``<wrapper>.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..channelizer import fused_channelize_planes, pfb_fir_planes  # noqa: F401  (plain versions)
from ..channelizer import fused_out_len
from ..rx.frontend import check_lags
from ..rx.frontend import (detection_metrics_planes, detection_metrics_wm_planes,  # noqa: F401
                           lag_rows_planes)  # (plain versions)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DET_VARIANTS = ("pp", "tile")


def _bind(lib, name: str, argtypes):
    """Declare ``lib``'s ``<name>_launch`` (``argtypes``, returning the
    launch's cudaError_t) and ``<name>_error_string``; returns ``lib``."""
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = argtypes
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check_rc(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


@functools.cache
def _det_lib():
    from ._build import load

    return _bind(load("det_metrics"), "det_metrics",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                 + [ctypes.c_int, ctypes.c_void_p])


def _check_planes(xf, name: str, sps: int) -> int:
    """Checks shared by the detection wrappers; returns ``sps`` as an int."""
    if not isinstance(xf, torch.Tensor):
        raise TypeError(f"{name} takes a torch tensor")
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"packed planes must be float32 or bfloat16, not {xf.dtype}")
    if xf.ndim < 2 or xf.shape[-2] != 2:
        raise ValueError(f"expected packed planes [..., 2, L], got {tuple(xf.shape)}")
    sps = int(sps)
    L = xf.shape[-1]
    if sps < 1 or L // sps < 2:
        raise ValueError(f"need at least two windows of {sps} samples, got L={L}")
    if xf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no detection kernel for device {xf.device}")
    if xf.device.type == "cuda" and not xf.is_contiguous():
        raise ValueError("the detection kernel reads contiguous planes")
    return sps


def _det_outputs(xf, sps: int):
    """``(lead, C, K1, corr [C, K], ener [C, K1])``, the outputs allocated
    on the planes' device."""
    lead = xf.shape[:-2]
    C = math.prod(lead)
    K1 = xf.shape[-1] // sps
    corr = torch.empty((C, K1 - 1), dtype=torch.float32, device=xf.device)
    ener = torch.empty((C, K1), dtype=torch.float32, device=xf.device)
    return lead, C, K1, corr, ener


def _det_split(lead, K1: int, corr, ener):
    K = K1 - 1
    return (corr.reshape(lead + (K,)), ener[:, :K].reshape(lead + (K,)),
            ener[:, 1:].reshape(lead + (K,)))


def detection_metrics_kernel(xf: torch.Tensor, sps: int, variant: str = "pp"):
    """Detection metrics of packed IQ ``[..., 2, L]`` (float32 or
    bfloat16): ``(corr, e1, e2)`` float32 ``[..., K]``, ``K = L//sps - 1``,
    as :func:`detection_metrics_planes` computes them.

    ``variant``: ``"pp"`` (K1, ``csrc/det_metrics.cu``) or ``"tile"``
    (K2, :func:`detection_metrics_tile_kernel`, which takes float32 and
    upcasts bfloat16 planes first); any other value raises ``ValueError``
    before anything else is looked at. CPU tensor: the plain version. CUDA
    tensor: the kernel; it must be contiguous. Raises on any other dtype,
    layout or device, and when the block holds fewer than two symbol
    windows.
    """
    if variant not in DET_VARIANTS:
        raise ValueError(f"unknown detection kernel variant: {variant!r}")
    if variant == "tile":
        return detection_metrics_tile_kernel(xf, sps)
    sps = _check_planes(xf, "detection_metrics_kernel", sps)
    if xf.device.type == "cpu":
        return detection_metrics_planes(xf, sps)
    lead, C, K1, corr, ener = _det_outputs(xf, sps)
    lib = _det_lib()
    with torch.cuda.device(xf.device):  # the C entry launches on the current device
        rc = lib.det_metrics_launch(
            xf.data_ptr(), corr.data_ptr(), ener.data_ptr(), C, xf.shape[-1], sps,
            _DTYPE_CODE[xf.dtype], torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "det_metrics", rc)
    detection_metrics_kernel.launches += 1
    return _det_split(lead, K1, corr, ener)


detection_metrics_kernel.launches = 0


@functools.cache
def _tile_lib():
    from ._build import load

    return _bind(load("det_tile"), "det_tile",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def detection_metrics_tile_kernel(xf: torch.Tensor, sps: int):
    """The ``"tile"`` variant of :func:`detection_metrics_kernel`: the same
    ``(corr, e1, e2)`` from ``csrc/det_tile.cu``, which stages ``[2, T+1,
    W]`` float32 slabs of the planes in shared memory. bfloat16 planes are
    upcast to float32 first, as the TPU kernel's caller does. CPU tensor:
    the plain version (on the float32 upcast). CUDA tensor: the kernel; it
    must be contiguous. Raises as :func:`detection_metrics_kernel` does."""
    sps = _check_planes(xf, "detection_metrics_tile_kernel", sps)
    if xf.device.type == "cpu":
        return detection_metrics_planes(xf.to(torch.float32), sps)
    xf = xf.to(torch.float32)
    lead, C, K1, corr, ener = _det_outputs(xf, sps)
    lib = _tile_lib()
    with torch.cuda.device(xf.device):  # the C entry launches on the current device
        rc = lib.det_tile_launch(xf.data_ptr(), corr.data_ptr(), ener.data_ptr(), C,
                                 xf.shape[-1], sps, torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "det_tile", rc)
    detection_metrics_tile_kernel.launches += 1
    return _det_split(lead, K1, corr, ener)


detection_metrics_tile_kernel.launches = 0


@functools.cache
def _wm_lib():
    from ._build import load

    return _bind(load("det_wm"), "det_wm",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def detection_metrics_wm_kernel(xw: torch.Tensor):
    """Detection metrics of window-major IQ ``[..., K1, 2, sps]`` float32:
    ``(corr, ener)`` float32 ``[..., K1]``, as
    :func:`detection_metrics_wm_planes` computes them (the last window
    paired with itself). Any ``K1 >= 1`` and ``sps >= 1``.

    CPU tensor: the plain version. CUDA tensor: the kernel
    (``csrc/det_wm.cu``); it must be contiguous. Raises on any other
    dtype, layout or device.
    """
    if not isinstance(xw, torch.Tensor):
        raise TypeError("detection_metrics_wm_kernel takes a torch tensor")
    if xw.dtype != torch.float32:
        raise TypeError(f"window-major IQ must be float32, not {xw.dtype}")
    if xw.ndim < 3 or xw.shape[-2] != 2 or xw.shape[-1] < 1 or xw.shape[-3] < 1:
        raise ValueError(f"expected window-major IQ [..., K1, 2, sps], got {tuple(xw.shape)}")
    if xw.device.type == "cpu":
        return detection_metrics_wm_planes(xw)
    if xw.device.type != "cuda":
        raise ValueError(f"no detection kernel for device {xw.device}")
    if not xw.is_contiguous():
        raise ValueError("the window-major detection kernel reads contiguous windows")
    lead = xw.shape[:-2]
    K1, sps = xw.shape[-3], xw.shape[-1]
    C = math.prod(lead[:-1])
    corr = torch.empty(lead, dtype=torch.float32, device=xw.device)
    ener = torch.empty(lead, dtype=torch.float32, device=xw.device)
    lib = _wm_lib()
    with torch.cuda.device(xw.device):  # the C entry launches on the current device
        rc = lib.det_wm_launch(xw.data_ptr(), corr.data_ptr(), ener.data_ptr(), C, K1, sps,
                               torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "det_wm", rc)
    detection_metrics_wm_kernel.launches += 1
    return corr, ener


detection_metrics_wm_kernel.launches = 0


def bind_pfb_lib(lib):
    """Declare the C entry points of a library built from
    ``csrc/pfb_fir.cu`` (the port's, or a tuning variant's); returns
    ``lib``."""
    return _bind(lib, "pfb_fir",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def _pfb_lib():
    from ._build import load

    return bind_pfb_lib(load("pfb_fir"))


def _pfb_vector_width(xf: torch.Tensor, h_poly: torch.Tensor, out: torch.Tensor) -> int:
    """Branches a thread of the polyphase FIR kernel owns: 16 bytes of
    input (4 float32 or 8 bfloat16 samples) when every such chunk of the
    planes ``xf`` and of the taps ``h_poly [K, M]`` is 16-byte aligned (the
    planes' base, their plane stride, ``M`` and the taps' base) and the
    ``[R, 2, M]`` buffer ``out`` takes stores of as many outputs; else 1,
    the kernel's scalar instantiation."""
    v = 16 // xf.element_size()
    store = min(16, v * out.element_size())
    if (xf.data_ptr() % 16 or xf.stride(0) * xf.element_size() % 16 or h_poly.shape[1] % v
            or h_poly.data_ptr() % 16 or out.data_ptr() % store):
        return 1
    return v


def _pfb_args(xf, h_poly, out) -> list:
    """``pfb_fir_launch``'s arguments but the stream, for ``out [R, 2, M]``."""
    K, M = h_poly.shape
    return [xf.data_ptr(), h_poly.data_ptr(), out.data_ptr(), M, K, xf.shape[-1] // M,
            xf.stride(0), M, 2 * M, _DTYPE_CODE[xf.dtype], _DTYPE_CODE[out.dtype],
            _pfb_vector_width(xf, h_poly, out)]


PFB_GEOMETRY_KEYS = ("Tc", "G", "S", "ring_slots", "ring_rows", "ring_bytes", "blocks_per_sm",
                     "runs", "col_tiles", "run_steps")


def pfb_fir_geometry(lib, xf, h_poly, out) -> dict:
    """The launch geometry ``lib``'s polyphase FIR kernel would take for
    :func:`pfb_fir_launch` with the same arguments (``PFB_GEOMETRY_KEYS``:
    threads across the branch tile, row groups, rows a step, the ring's
    slots, rows and bytes, resident blocks an SM, the grid's runs and
    column tiles, steps a run) and the vector width; launches nothing.
    Raises ``RuntimeError`` where the launch would fail."""
    fn = lib.pfb_fir_geometry
    fn.argtypes = lib.pfb_fir_launch.argtypes[:-1] + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    geom = (ctypes.c_longlong * len(PFB_GEOMETRY_KEYS))()
    args = _pfb_args(xf, h_poly, out)
    with torch.cuda.device(xf.device):
        rc = fn(*args, geom)
    _check_rc(lib, "pfb_fir", rc)
    return dict(zip(PFB_GEOMETRY_KEYS, geom)) | {"vec": args[-1]}


def pfb_fir_launch(lib, xf, h_poly, out) -> None:
    """Launch ``lib``'s polyphase FIR kernel on checked CUDA tensors (see
    :func:`pfb_fir_kernel`) into ``out`` ``[R, 2, M]``, at the width
    :func:`_pfb_vector_width` picks, on the planes' device and its current
    stream; raises ``RuntimeError`` when the launch fails."""
    with torch.cuda.device(xf.device):  # the C entry launches on the current device
        rc = lib.pfb_fir_launch(*_pfb_args(xf, h_poly, out),
                                torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "pfb_fir", rc)


def pfb_fir_kernel(xf: torch.Tensor, h_poly: torch.Tensor,
                   out_dtype=torch.float32, out=None) -> torch.Tensor:
    """Polyphase branch FIR of packed wideband planes ``[2, L]`` (float32
    or bfloat16) with float32 taps ``[K, M]``: ``[2, n_out, M]`` in
    ``out_dtype``, as :func:`pfb_fir_planes` computes it, bit for bit
    (``n_vec = L // M``, ``n_out = n_vec - K + 1``).

    CPU tensors: the plain version. CUDA tensors: the kernel, which reads
    the planes where they lie (each plane's samples contiguous, any plane
    stride, so ``xf[:, :n]`` needs no copy) and writes an ``[n_out, 2, M]``
    buffer, returned as its ``[2, n_out, M]`` view: its rows ``[fr | fi]``
    are what the DFT product reads. It launches the kernel's vector
    instantiation (a thread owns 16 bytes of input: 4 float32 or 8 bfloat16
    branches) where :func:`_pfb_vector_width` finds the planes and the
    output aligned for it, else its scalar instantiation (one branch a
    thread, e.g. an odd plane stride or ``M``). ``out``: an optional
    contiguous ``[R, 2, M]`` buffer (``R >= n_out``, ``out_dtype``, on the
    planes' device) whose first ``n_out`` rows take the result (on the CPU
    by a copy); the others are left as they are. Raises on any other dtype,
    shape, layout or device, and when ``n_vec < K``; on the card a launch
    also raises ``RuntimeError`` for a K whose shared-memory row ring does
    not fit (past 359 taps a branch for aligned float32 planes at M > 64,
    more at smaller M; the limits are in ``csrc/pfb_fir.cu``).
    """
    if not isinstance(xf, torch.Tensor) or not isinstance(h_poly, torch.Tensor):
        raise TypeError("pfb_fir_kernel takes torch tensors")
    for what, dt in (("planes", xf.dtype), ("output", out_dtype)):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"{what} must be float32 or bfloat16, not {dt}")
    if h_poly.dtype != torch.float32:
        raise TypeError(f"taps must be float32, not {h_poly.dtype}")
    if xf.ndim != 2 or xf.shape[0] != 2:
        raise ValueError(f"expected packed planes [2, L], got {tuple(xf.shape)}")
    if h_poly.ndim != 2 or min(h_poly.shape) < 1:
        raise ValueError(f"expected taps [K, M], got {tuple(h_poly.shape)}")
    K, M = h_poly.shape
    n_vec = xf.shape[-1] // M
    if n_vec < K:
        raise ValueError(f"need at least K={K} rows of M={M} samples, got L={xf.shape[-1]}")
    if xf.device != h_poly.device:
        raise ValueError(f"planes on {xf.device}, taps on {h_poly.device}")
    n_out = n_vec - K + 1
    if out is not None and (
            out.dtype != out_dtype or out.device != xf.device or out.ndim != 3
            or tuple(out.shape[1:]) != (2, M) or out.shape[0] < n_out
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [>= {n_out}, 2, {M}] {out_dtype} "
                         f"buffer on {xf.device}")
    if xf.device.type == "cpu":
        res = pfb_fir_planes(xf, h_poly, out_dtype)
        if out is None:
            return res
        out[:n_out].copy_(res.transpose(0, 1))
        return out[:n_out].transpose(0, 1)
    if xf.device.type != "cuda":
        raise ValueError(f"no polyphase FIR kernel for device {xf.device}")
    if xf.stride(1) != 1 or not h_poly.is_contiguous():
        raise ValueError("the polyphase FIR kernel reads contiguous plane rows and taps")
    if out is None:
        out = torch.empty((n_out, 2, M), dtype=out_dtype, device=xf.device)
    pfb_fir_launch(_pfb_lib(), xf, h_poly, out)
    pfb_fir_kernel.launches += 1
    return out[:n_out].transpose(0, 1)


pfb_fir_kernel.launches = 0


def bind_lag_lib(lib):
    """Declare the C entry points of a library built from
    ``csrc/lag_rows.cu`` (the port's, or a tuning variant's); returns
    ``lib``."""
    return _bind(lib, "lag_rows",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 5
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def _lag_lib():
    from ._build import load

    return bind_lag_lib(load("lag_rows"))


@functools.cache
def _lag_table(lags: tuple, device: torch.device) -> torch.Tensor:
    """The lags as an int32 tensor on ``device``, copied there once."""
    return torch.tensor(lags, dtype=torch.int32, device=device)


def _lag_vector_width(x3: torch.Tensor, sps: int) -> int:
    """Samples a copy of the multi-lag kernel moves for planes ``x3 [C, 2,
    L]``: 16 bytes' worth (4 float32 or 8 bf16) when every row's chunks of
    16 bytes are aligned (the planes' base, their plane and channel
    strides and ``sps``), else 1, the kernel's scalar instantiation."""
    size = x3.element_size()
    v = 16 // size
    if (x3.data_ptr() % 16 or x3.stride(1) % v or (x3.shape[0] > 1 and x3.stride(0) % v)
            or sps % v):
        return 1
    return v


def lag_rows_launch(lib, x3, sps: int, lags: tuple, out) -> None:
    """Launch ``lib``'s multi-lag kernel on checked CUDA planes ``x3 [C, 2,
    L]`` (each plane's samples contiguous) into ``out [C, 1 + 2 *
    len(lags), L // sps]``, at the width :func:`_lag_vector_width` picks,
    on the planes' device and its current stream; raises ``RuntimeError``
    when the launch fails."""
    C, _, L = x3.shape
    with torch.cuda.device(x3.device):  # the C entry launches on the current device
        rc = lib.lag_rows_launch(
            x3.data_ptr(), _lag_table(lags, x3.device).data_ptr(), out.data_ptr(), C, L, sps,
            x3.stride(1), x3.stride(0), len(lags), lags[-1], _DTYPE_CODE[x3.dtype],
            _lag_vector_width(x3, sps), torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "lag_rows", rc)


def lag_rows_kernel(xf: torch.Tensor, sps_min: int, lags):
    """Fine-row energies and lag products of packed IQ ``[..., 2, L]``
    (float32 or bfloat16): ``(e, {lag: (q_re, q_im)})``, each float32
    ``[..., R]`` with ``R = L // sps_min``, as :func:`lag_rows_planes`
    computes them (``q`` zero for rows ``r >= R - lag``).

    CPU tensor: the plain version. CUDA tensor: the kernel, one launch for
    every lag, which reads the planes where they lie: each plane's samples
    contiguous, any plane and channel stride (the channelizer's pitched
    view needs no copy; leading dimensions that do not merge into one
    channel stride are copied first). It copies 16 bytes at a time where
    :func:`_lag_vector_width` finds the planes aligned for it, else one
    sample. Raises on any other dtype, layout or device, on a lag below 1,
    and when the block holds no row.
    """
    if not isinstance(xf, torch.Tensor):
        raise TypeError("lag_rows_kernel takes a torch tensor")
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"packed planes must be float32 or bfloat16, not {xf.dtype}")
    if xf.ndim < 2 or xf.shape[-2] != 2:
        raise ValueError(f"expected packed planes [..., 2, L], got {tuple(xf.shape)}")
    lags = check_lags(lags)
    sps_min = int(sps_min)
    L = xf.shape[-1]
    if sps_min < 1 or L // sps_min < 1:
        raise ValueError(f"need at least one row of {sps_min} samples, got L={L}")
    if xf.device.type == "cpu":
        return lag_rows_planes(xf, sps_min, lags)
    if xf.device.type != "cuda":
        raise ValueError(f"no lag-rows kernel for device {xf.device}")
    if xf.stride(-1) != 1:
        raise ValueError("the lag-rows kernel reads planes whose samples are contiguous")
    lead = xf.shape[:-2]
    C = math.prod(lead)
    R = L // sps_min
    S = 1 + 2 * len(lags)
    out = torch.empty((C, S, R), dtype=torch.float32, device=xf.device)
    lag_rows_launch(_lag_lib(), xf.reshape(C, 2, L), sps_min, lags, out)
    lag_rows_kernel.launches += 1
    out = out.reshape(lead + (S, R))
    return out[..., 0, :], {lag: (out[..., 1 + 2 * s, :], out[..., 2 + 2 * s, :])
                            for s, lag in enumerate(lags)}


lag_rows_kernel.launches = 0


def bind_fused_lib(lib):
    """Declare the C entry points of a library built from
    ``csrc/fused_chan.cu`` (the port's, or a tuning variant's); returns
    ``lib``."""
    return _bind(lib, "fused_chan",
                 [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])


@functools.cache
def _fused_lib():
    from ._build import load

    return bind_fused_lib(load("fused_chan"))


def fused_chan_launch(lib, xf, ramp, mix, decimation: int, n_taps: int, out) -> None:
    """Launch ``lib``'s fused channelizer kernel on checked CUDA tensors
    (see :func:`fused_channelize_kernel`) into ``out`` ``[C, 2, n_out]``,
    on the planes' device and its current stream; raises
    ``RuntimeError`` when the launch fails (also for a ``K`` past the
    kernel's limit)."""
    o_re, o_im, i_re, i_im = ramp
    h, phi = mix
    C, _, n_out = out.shape
    with torch.cuda.device(xf.device):  # the C entry launches on the current device
        rc = lib.fused_chan_launch(
            xf.data_ptr(), xf.stride(0), xf.shape[-1], h.data_ptr(), phi.data_ptr(), C,
            decimation, -(-n_taps // decimation), o_re.data_ptr(), o_im.data_ptr(),
            o_re.shape[-1], i_re.data_ptr(), i_im.data_ptr(), i_re.shape[-1], out.data_ptr(),
            n_out, torch.cuda.current_stream().cuda_stream)
    _check_rc(lib, "fused_chan", rc)


def fused_channelize_kernel(xf: torch.Tensor, g2: torch.Tensor, ramp, decimation: int,
                            n_taps: int, mix) -> torch.Tensor:
    """Mix + decimating FIR + output ramp of packed wideband planes ``[2,
    L]`` float32 for all ``C`` channels of a plan: ``[C, 2, n_out]``
    float32, ``n_out = (L - n_taps) // D + 1``, as
    :func:`fused_channelize_planes` computes it. The tables, all float32
    (:func:`~lora_tpu_torch.channelizer.fused_tables` builds them): the
    folded FIR matrix ``g2`` ``[2C, K*2D]`` (``K = ceil(n_taps / D)``),
    the ramp factors ``(o_re, o_im, i_re, i_im)`` ``[C, nb]``, ``[C,
    nb]``, ``[C, tile]``, ``[C, tile]`` (``nb = ceil(n_out / tile)``) and
    ``mix = (h, phi)``, the zero-padded real taps ``[K*D]`` and the phase
    table ``[C, 2, D]``.

    CPU tensors: the plain version (folded: ``g2`` and the ramp). CUDA
    tensors: the kernel (factored: the ramp, ``h`` and ``phi``), which
    reads the planes where they lie (each plane's samples contiguous, any
    plane stride); the tables must be contiguous, and the launch raises
    ``RuntimeError`` for ``256 + K - 1 > tile``. Raises on any other
    dtype, shape, layout or device, and when the block is shorter than the
    filter.
    """
    if not isinstance(mix, (tuple, list)) or len(mix) != 2:
        raise TypeError("mix must be the pair (h, phi)")
    tens = (xf, g2, *ramp, *mix)
    if len(ramp) != 4 or not all(isinstance(t, torch.Tensor) for t in tens):
        raise TypeError("fused_channelize_kernel takes torch tensors and four ramp factors")
    if any(t.dtype != torch.float32 for t in tens):
        raise TypeError(f"planes, g2, ramp and mix must be float32, not "
                        f"{[t.dtype for t in tens]}")
    if any(t.device != xf.device for t in tens):
        raise ValueError(f"planes on {xf.device}, tables on {[str(t.device) for t in tens[1:]]}")
    if xf.ndim != 2 or xf.shape[0] != 2:
        raise ValueError(f"expected packed planes [2, L], got {tuple(xf.shape)}")
    D = int(decimation)
    n_taps = int(n_taps)
    if D < 1 or n_taps < 1:
        raise ValueError(f"need decimation >= 1 and n_taps >= 1, got {D}, {n_taps}")
    K = -(-n_taps // D)
    if g2.ndim != 2 or g2.shape[0] % 2 or g2.shape[0] < 2 or g2.shape[1] != K * 2 * D:
        raise ValueError(f"g2 must be [2C, {K * 2 * D}] for D={D}, {n_taps} taps; "
                         f"got {tuple(g2.shape)}")
    C = g2.shape[0] // 2
    L = xf.shape[-1]
    n_out = fused_out_len(L, n_taps, D)
    o_re, o_im, i_re, i_im = ramp
    tile = i_re.shape[-1] if i_re.ndim == 2 else 0
    nb = -(-n_out // tile) if tile else 0
    if (tile < 1 or any(t.shape != (C, nb) for t in (o_re, o_im))
            or any(t.shape != (C, tile) for t in (i_re, i_im))):
        raise ValueError(f"ramp factors must be [{C}, nb], [{C}, nb], [{C}, tile], [{C}, tile] "
                         f"with nb = ceil({n_out} / tile); got "
                         f"{[tuple(t.shape) for t in ramp]}")
    h, phi = mix
    if tuple(h.shape) != (K * D,) or tuple(phi.shape) != (C, 2, D):
        raise ValueError(f"mix must be h [{K * D}] and phi [{C}, 2, {D}]; got "
                         f"{tuple(h.shape)}, {tuple(phi.shape)}")
    if xf.device.type == "cpu":
        return fused_channelize_planes(xf, g2, ramp, D, n_taps, tile)
    if xf.device.type != "cuda":
        raise ValueError(f"no fused channelizer kernel for device {xf.device}")
    if xf.stride(1) != 1 or not all(t.is_contiguous() for t in tens[1:]):
        raise ValueError("the fused channelizer kernel reads contiguous plane rows and tables")
    out = torch.empty((C, 2, n_out), dtype=torch.float32, device=xf.device)
    fused_chan_launch(_fused_lib(), xf, ramp, mix, D, n_taps, out)
    fused_channelize_kernel.launches += 1
    return out


fused_channelize_kernel.launches = 0
