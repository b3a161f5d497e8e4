"""Launcher of ``csrc/flash_attention.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the instantiations of the kernel
BQ = 64                                  # query rows per block
_MAX_GRID_Y = 65535
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p])


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides in elements of a (B, heads, S, D) view."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map can describe ``t``: a 16-byte aligned base
    and strides of 16-byte multiples on every dimension longer than 1 (as
    every contiguous view of the port's head dims has)."""
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * t.element_size()) % 16 == 0 for i in range(3) if t.shape[i] > 1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float = 0.0, prefix_len: int = 0) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, KV, S, D), f32 or bf16, any strides with
    the last dimension contiguous (the model passes transposed views of its
    (B, S, heads, D) projections).  Returns (B, H, S, D) in q's type, a view
    of a (B, S, H, D) tensor, so that ``.transpose(1, 2)`` is contiguous.
    bf16 runs the tensor-core kernel, f32 the CUDA-core one."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA device")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} "
                         "are not (B, H, S, D), (B, KV, S, D), (B, KV, S, D)")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs the head dim contiguous")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the launch grid")
    if q.dtype == torch.bfloat16 and not all(_tma_ready(t) for t in (q, k, v)):
        raise ValueError("flash_attention_cuda (bf16) needs 16-byte aligned bases and "
                         "strides: pass contiguous views")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", _SYMBOLS[q.dtype], _ARGTYPES)
    scale = float(np.float32(1.0 / math.sqrt(d)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, h, kvh, s, d, *_strides(q), *_strides(k), *_strides(v),
                        *_strides(out), scale, float(softcap), int(window or 0),
                        int(prefix_len), int(bool(causal)), stream), "flash_attention")
    _build.launch_counts["flash_attention"] += 1
    return out
