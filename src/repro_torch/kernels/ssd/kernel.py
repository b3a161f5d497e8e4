"""Launcher of ``csrc/ssd_chunk.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

RS = 32                  # rows of a score strip (csrc/ssd_chunk.cu)
MAX_P = 128              # head dims up to 4 x 32 lanes
SMEM_LIMIT = 232_448     # shared memory one block may take on an H100
_MAX_GRID_X = 2 ** 31 - 1
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 7 + [ctypes.c_void_p])


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of one block: x (Q, P), B (Q, N + 1), the state (N, P),
    a C strip (RS, N), a score strip (RS, Q), and dt, its cumsum and the
    state weights (3 Q), all f32."""
    return 4 * (q * p + q * (n + 1) + n * p + RS * n + RS * q + 3 * q)


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, d_vec: torch.Tensor,
                   chunk: int, return_state: bool = False):
    """x (B, S, H, P), dt (B, S, H), a (H,), b_mat/c_mat (B, S, G, N),
    d_vec (H,), all f32 on one CUDA device.  Returns y (B, S, H, P) and, with
    ``return_state``, the final states (B, H, N, P)."""
    args = (x, dt, a, b_mat, c_mat, d_vec)
    if not all(t.is_cuda for t in args) or len({t.device for t in args}) != 1:
        raise ValueError("ssd_chunk_cuda needs every input on one CUDA device")
    if any(t.dtype != torch.float32 for t in args):
        raise ValueError("ssd_chunk_cuda takes f32 inputs, got "
                         + "/".join(str(t.dtype) for t in args))
    if x.dim() != 4 or b_mat.dim() != 4 or b_mat.shape != c_mat.shape:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(b_mat.shape)}, "
                         f"{tuple(c_mat.shape)} are not (B, S, H, P), (B, S, G, N) x2")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if dt.shape != (bsz, s, h) or a.shape != (h,) or d_vec.shape != (h,) \
            or b_mat.shape[:2] != (bsz, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, d {tuple(d_vec.shape)} "
                         f"do not fit x {tuple(x.shape)} and B {tuple(b_mat.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"head dim {p} outside the kernel's 1..{MAX_P}")
    if smem_bytes(chunk, p, n) > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk}, P {p}, N {n} need {smem_bytes(chunk, p, n)} B "
                         f"of shared memory, above {SMEM_LIMIT}")
    if bsz * h > _MAX_GRID_X:
        raise ValueError(f"B*H = {bsz * h} exceeds the launch grid")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("ssd_chunk_cuda needs contiguous inputs")
    y = torch.empty_like(x)
    h_fin = (torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if return_state else None)
    if x.numel() == 0:
        return (y, h_fin) if return_state else y
    fn = _build.function("ssd_chunk", "ssd_chunk_f32", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                        c_mat.data_ptr(), d_vec.data_ptr(), y.data_ptr(),
                        0 if h_fin is None else h_fin.data_ptr(),
                        bsz, s, h, g, p, n, chunk, stream), "ssd_chunk")
    _build.launch_counts["ssd_chunk"] += 1
    return (y, h_fin) if return_state else y
