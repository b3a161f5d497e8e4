"""Public SSD wrapper: the CUDA kernel on the card, ref.py on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel, ref


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, d_vec: torch.Tensor,
                chunk: int = 128, return_state: bool = False):
    """The SSD chunk scan in the model layout: x (B, S, H, P), dt (B, S, H)
    (post-softplus), a (H,) negative, b_mat/c_mat (B, S, G, N), d_vec (H,).
    x, B and C may be the model's bf16 (or f32) views; dt, a and D are f32.

    Returns y (B, S, H, P) f32, and with ``return_state`` also the final
    states (B, H, N, P) f32.  CPU tensors run the plain version, which widens
    its inputs to f32 itself; CUDA tensors launch the kernel (three CUDA
    kernels, counted as one launch) or raise.
    """
    if x.device.type == "cpu":
        y, h = ref.ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_vec, chunk)
        return (y, h) if return_state else y
    return kernel.ssd_chunk_cuda(x, dt, a, b_mat, c_mat, d_vec, chunk, return_state)
