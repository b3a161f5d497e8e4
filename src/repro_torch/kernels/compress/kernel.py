"""Launcher of ``csrc/fused_assemble_id.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SMEM_TOO_LARGE = -2


def smem_bytes(m: int, s: int, k: int) -> int:
    """Shared memory one node needs (the kernel's own count)."""
    fn = _build.function("fused_assemble_id", "fused_assemble_id_smem_bytes",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    return int(fn(m, s, k))


def fused_assemble_id_cuda(xc: torch.Tensor, xp: torch.Tensor, cmask: torch.Tensor,
                           k: int, h: float) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, m, f), xp (B, s, f), cmask (B, m), all f32 on one CUDA device
    -> (piv (B, k) int32, R (B, k, m) f32).  One launch for all B nodes.

    Raises without launching when a node needs more shared memory than the
    card gives one block.
    """
    tensors = (xc, xp, cmask)
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("fused_assemble_id_cuda needs all inputs on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("fused_assemble_id_cuda takes f32 inputs")
    if xc.dim() != 3 or xp.dim() != 3 or xp.shape[0] != xc.shape[0] \
            or xp.shape[2] != xc.shape[2] or cmask.shape != xc.shape[:2]:
        raise ValueError(f"shapes xc {tuple(xc.shape)}, xp {tuple(xp.shape)}, "
                         f"cmask {tuple(cmask.shape)} do not match")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_assemble_id_cuda needs contiguous inputs")
    batch, m, f = xc.shape
    s = xp.shape[1]
    if not 1 <= k <= m or s < 1:
        raise ValueError(f"need 1 <= k <= m and s >= 1, got k={k}, m={m}, s={s}")
    piv = torch.empty((batch, k), dtype=torch.int32, device=xc.device)
    r = torch.empty((batch, k, m), dtype=torch.float32, device=xc.device)
    if batch == 0:
        return piv, r
    fn = _build.function("fused_assemble_id", "fused_assemble_id_gaussian", _ARGTYPES)
    scale = float(np.float32(-0.5 / (h * h)))
    dev = xc.device.index if xc.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = fn(xc.data_ptr(), xp.data_ptr(), cmask.data_ptr(), piv.data_ptr(),
                 r.data_ptr(), batch, m, s, f, k, scale, dev,
                 torch.cuda.current_stream().cuda_stream)
    if err == _SMEM_TOO_LARGE:
        raise ValueError(
            f"fused_assemble_id: a node of m={m}, s={s}, k={k} needs "
            f"{smem_bytes(m, s, k)} bytes of shared memory, more than the card "
            "gives one block")
    _build.check(err, "fused_assemble_id")
    _build.launch_counts["fused_assemble_id"] += 1
    return piv, r
