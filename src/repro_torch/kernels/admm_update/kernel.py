"""Launcher of ``csrc/zmu_update.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def fused_zmu_update_cuda(x: torch.Tensor, mu: torch.Tensor, c_vec: torch.Tensor,
                          beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 x, μ, c of one length on one CUDA device -> (z, μ⁺)."""
    tensors = (x, mu, c_vec)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_zmu_update_cuda needs all inputs on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("fused_zmu_update_cuda takes f32 inputs")
    if x.dim() != 1 or mu.shape != x.shape or c_vec.shape != x.shape:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(mu.shape)}, "
                         f"{tuple(c_vec.shape)} are not one flat length")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_zmu_update_cuda needs contiguous inputs")
    z = torch.empty_like(x)
    mu_new = torch.empty_like(x)
    if x.numel() == 0:
        return z, mu_new
    fn = _build.function("zmu_update", "zmu_update_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        _build.check(fn(x.data_ptr(), mu.data_ptr(), c_vec.data_ptr(), z.data_ptr(),
                        mu_new.data_ptr(), x.numel(), float(np.float32(1.0 / beta)),
                        float(beta), torch.cuda.current_stream().cuda_stream),
                     "zmu_update")
    _build.launch_counts["zmu_update"] += 1
    return z, mu_new
