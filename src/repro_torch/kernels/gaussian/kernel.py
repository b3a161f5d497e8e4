"""Launcher of ``csrc/gaussian_block.cu`` (CUDA tensors only).

The launch plan (skinny, packed or wide) is ``kernels.pairwise.plan``'s,
shared with the laplacian block (K4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import pairwise


def gaussian_block_cuda(xa: torch.Tensor, xb: torch.Tensor, h: float, *,
                        family: str | None = None) -> torch.Tensor:
    """(B, Ma, F) x (B, Mb, F) -> (B, Ma, Mb) in the input type (f32 or bf16).
    One launch; ``family`` forces a plan (``pairwise.plan``)."""
    scale = float(np.float32(-0.5 / (h * h)))
    return pairwise.pairwise_block_cuda("gaussian_block", xa, xb, scale, family=family)
