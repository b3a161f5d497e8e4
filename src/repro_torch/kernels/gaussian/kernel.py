"""Launcher of ``csrc/gaussian_block.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_SYMBOLS = {torch.float32: "gaussian_block_f32",
            torch.bfloat16: "gaussian_block_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float, ctypes.c_void_p]
_TM = 64          # output tile rows of the kernel (grid.y = ceil(Ma / 64))
_MAX_GRID_Y = 65535
_MAX_GRID_Z = 65535   # batch entries per launch (the C launcher chunks the batch)


def gaussian_block_cuda(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """(B, Ma, F) x (B, Mb, F) -> (B, Ma, Mb) in the input type (f32 or bf16)."""
    if not (xa.is_cuda and xb.is_cuda) or xa.device != xb.device:
        raise ValueError("gaussian_block_cuda needs both inputs on one CUDA device")
    if xa.dtype not in _SYMBOLS or xb.dtype != xa.dtype:
        raise ValueError(f"gaussian_block_cuda takes f32 or bf16, got {xa.dtype}/{xb.dtype}")
    if xa.dim() != 3 or xb.dim() != 3 or xa.shape[0] != xb.shape[0] \
            or xa.shape[2] != xb.shape[2]:
        raise ValueError(f"shapes {tuple(xa.shape)} x {tuple(xb.shape)} are not "
                         "(B, Ma, F) x (B, Mb, F)")
    if not (xa.is_contiguous() and xb.is_contiguous()):
        raise ValueError("gaussian_block_cuda needs contiguous inputs")
    batch, ma, f = xa.shape
    mb = xb.shape[1]
    if -(-ma // _TM) > _MAX_GRID_Y:
        raise ValueError(f"rows {ma} exceed the launch grid")
    out = torch.empty((batch, ma, mb), dtype=xa.dtype, device=xa.device)
    if out.numel() == 0:
        return out
    fn = _build.function("gaussian_block", _SYMBOLS[xa.dtype], _ARGTYPES)
    scale = float(np.float32(-0.5 / (h * h)))
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(xa.data_ptr(), xb.data_ptr(), out.data_ptr(),
                        batch, ma, mb, f, scale, stream), "gaussian_block")
    _build.launch_counts["gaussian_block"] += -(-batch // _MAX_GRID_Z)   # chunks
    return out
