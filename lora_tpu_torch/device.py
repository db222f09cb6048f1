"""Device resolution and matmul precision for the port.

Entry points run on the card unless the caller asks for the CPU:
``None`` resolves to ``cuda``, and asking for ``cuda`` on a machine
without one raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if the device asked for is CUDA and no
    CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lora_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matmuls and convolutions in full float32, never TF32,
    inside the block.

    The fold-DFT and table matmuls of the receiver are held to a float32
    CPU reference; TF32 keeps about three decimal digits and would move
    bin decisions. cuDNN's convolutions, which run in TF32 by default, are
    pinned too. bfloat16 products also keep float32 sums to the end:
    cuBLAS's reduced-precision (bf16) split-K reduction is off. The
    previous settings are restored on exit."""
    old = torch.get_float32_matmul_precision()
    cuda_mm = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    old_bf16 = cuda_mm.allow_bf16_reduced_precision_reduction
    old_conv = cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    cuda_mm.allow_bf16_reduced_precision_reduction = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
        cuda_mm.allow_bf16_reduced_precision_reduction = old_bf16
        cudnn.allow_tf32 = old_conv
