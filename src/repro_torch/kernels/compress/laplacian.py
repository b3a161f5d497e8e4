"""K4: batched laplacian kernel block (CUDA twin of repro.kernels.compress.laplacian).

``laplacian_block`` is the public wrapper: CPU tensors run the plain
version (``ref.laplacian_block_ref``), CUDA tensors launch
``csrc/laplacian_block.cu`` through ``laplacian_block_cuda`` or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import pairwise
from repro_torch.kernels.compress import ref


def laplacian_block_cuda(xa: torch.Tensor, xb: torch.Tensor, h: float, *,
                         family: str | None = None) -> torch.Tensor:
    """(B, Ma, F) x (B, Mb, F) -> (B, Ma, Mb) in the input type (f32 or bf16).
    One launch, on ``pairwise.plan``'s plan (shared with the Gaussian block,
    K1); ``family`` forces one."""
    neg_inv_h = -float(np.float32(1.0 / h))
    return pairwise.pairwise_block_cuda("laplacian_block", xa, xb, neg_inv_h, family=family)


def laplacian_block(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """exp(-||xa - xb||_1 / h): (Ma, F) x (Mb, F) -> (Ma, Mb), or batched
    (B, ·, F) -> (B, Ma, Mb).

    The device of the inputs decides: CPU tensors run the plain version,
    CUDA tensors launch the kernel (one launch, whatever the batch) or
    raise.
    """
    if xa.device.type == "cpu":
        return ref.laplacian_block_ref(xa, xb, h)
    if xa.dim() == 2:
        return laplacian_block_cuda(xa.contiguous()[None], xb.contiguous()[None], h)[0]
    return laplacian_block_cuda(xa.contiguous(), xb.contiguous(), h)
