"""Launcher of ``csrc/fused_assemble_id.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_KINDS = {"gaussian": 0, "laplacian": 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# Where the C planner puts a node's Q basis.
Q_IN_SHARED, Q_IN_GLOBAL = 0, 1
_SMEM_TOO_LARGE = -2


def smem_bytes(m: int, s: int, k: int, q_global: bool = False) -> int:
    """Shared memory one node needs (the kernel's own count), with Q in
    shared memory or in the per-node global scratch."""
    fn = _build.function("fused_assemble_id", "fused_assemble_id_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(m, s, k, int(q_global)))


def plan(m: int, s: int, k: int, device: int) -> int:
    """Q_IN_SHARED when a node fits with Q beside the residual, Q_IN_GLOBAL
    when it fits only with Q in a global scratch; raises when neither fits."""
    fn = _build.function("fused_assemble_id", "fused_assemble_id_plan",
                         [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    where = ctypes.c_int(0)
    _build.check(fn(m, s, k, device, ctypes.byref(where)), "fused_assemble_id_plan")
    if where.value == _SMEM_TOO_LARGE:
        raise ValueError(
            f"fused_assemble_id: a node of m={m}, s={s}, k={k} needs "
            f"{smem_bytes(m, s, k, True)} bytes of shared memory even with Q "
            "in global memory, more than the card gives one block")
    return where.value


def fused_assemble_id_cuda(xc: torch.Tensor, xp: torch.Tensor, cmask: torch.Tensor,
                           k: int, h: float, kernel_name: str = "gaussian"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, m, f), xp (B, s, f), cmask (B, m), all f32 on one CUDA device
    -> (piv (B, k) int32, R (B, k, m) f32).  One launch for all B nodes.

    Where a node does not fit in shared memory with its Q basis (the
    accurate preset's leaf), Q goes to a scratch of B·k·s floats allocated
    here.  Raises without launching when a node fits neither way.
    """
    tensors = (xc, xp, cmask)
    if kernel_name not in _KINDS:
        raise ValueError(f"unknown kernel {kernel_name!r}")
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
    dev = xc.device.index if xc.device.index is not None else torch.cuda.current_device()
    q_scratch = None
    if plan(m, s, k, dev) == Q_IN_GLOBAL:
        q_scratch = torch.empty((batch, k, s), dtype=torch.float32, device=xc.device)
    # The gaussian branch takes -1/2h² (rounded to f32 as the reference
    # does); the laplacian branch divides by h itself, as the reference does.
    param = (float(np.float32(-0.5 / (h * h))) if kernel_name == "gaussian"
             else float(h))
    fn = _build.function("fused_assemble_id", "fused_assemble_id_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(_KINDS[kernel_name], xc.data_ptr(), xp.data_ptr(), cmask.data_ptr(),
                 piv.data_ptr(), r.data_ptr(),
                 0 if q_scratch is None else q_scratch.data_ptr(),
                 batch, m, s, f, k, param, dev,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_assemble_id")
    _build.launch_counts["fused_assemble_id"] += 1
    return piv, r
