"""K4: batched laplacian kernel block (CUDA twin of repro.kernels.compress.laplacian).

``laplacian_block`` is the public wrapper: CPU tensors run the plain
version (``ref.laplacian_block_ref``), CUDA tensors launch
``csrc/laplacian_block.cu`` through ``laplacian_block_cuda`` or raise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compress import ref

_SYMBOLS = {torch.float32: "laplacian_block_f32",
            torch.bfloat16: "laplacian_block_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float, ctypes.c_void_p]
_TM = 64          # output tile rows of the kernel (grid.y = ceil(Ma / 64))
_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535   # batch entries per launch (the C launcher chunks the batch)


def laplacian_block_cuda(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """(B, Ma, F) x (B, Mb, F) -> (B, Ma, Mb) in the input type (f32 or bf16)."""
    if not (xa.is_cuda and xb.is_cuda) or xa.device != xb.device:
        raise ValueError("laplacian_block_cuda needs both inputs on one CUDA device")
    if xa.dtype not in _SYMBOLS or xb.dtype != xa.dtype:
        raise ValueError(f"laplacian_block_cuda takes f32 or bf16, got {xa.dtype}/{xb.dtype}")
    if xa.dim() != 3 or xb.dim() != 3 or xa.shape[0] != xb.shape[0] \
            or xa.shape[2] != xb.shape[2]:
        raise ValueError(f"shapes {tuple(xa.shape)} x {tuple(xb.shape)} are not "
                         "(B, Ma, F) x (B, Mb, F)")
    if not (xa.is_contiguous() and xb.is_contiguous()):
        raise ValueError("laplacian_block_cuda needs contiguous inputs")
    batch, ma, f = xa.shape
    mb = xb.shape[1]
    if -(-ma // _TM) > _MAX_GRID_Y:
        raise ValueError(f"rows {ma} exceed the launch grid")
    out = torch.empty((batch, ma, mb), dtype=xa.dtype, device=xa.device)
    if out.numel() == 0:
        return out
    fn = _build.function("laplacian_block", _SYMBOLS[xa.dtype], _ARGTYPES)
    neg_inv_h = -float(np.float32(1.0 / h))
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(xa.data_ptr(), xb.data_ptr(), out.data_ptr(),
                        batch, ma, mb, f, neg_inv_h, stream), "laplacian_block")
    _build.launch_counts["laplacian_block"] += -(-batch // _MAX_GRID_Z)   # chunks
    return out


def laplacian_block(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """exp(-||xa - xb||_1 / h): (Ma, F) x (Mb, F) -> (Ma, Mb), or batched
    (B, ·, F) -> (B, Ma, Mb).

    The device of the inputs decides: CPU tensors run the plain version,
    CUDA tensors launch the kernel (one launch per 65535 entries of the
    batch) or raise.
    """
    if xa.device.type == "cpu":
        return ref.laplacian_block_ref(xa, xb, h)
    if xa.dim() == 2:
        return laplacian_block_cuda(xa.contiguous()[None], xb.contiguous()[None], h)[0]
    return laplacian_block_cuda(xa.contiguous(), xb.contiguous(), h)
