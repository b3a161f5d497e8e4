"""Public Gaussian-block wrapper: the CUDA kernel on the card, ref.py on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.gaussian import kernel, ref


def gaussian_block(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """K(xa, xb): (Ma, F) x (Mb, F) -> (Ma, Mb), or batched (B, ·, F) -> (B, Ma, Mb).

    The device of the inputs decides: CPU tensors run the plain version,
    CUDA tensors launch the kernel (one launch, whatever the batch) or
    raise.
    """
    if xa.device.type == "cpu":
        return ref.gaussian_block_ref(xa, xb, h)
    if xa.dim() == 2:
        return kernel.gaussian_block_cuda(
            xa.contiguous()[None], xb.contiguous()[None], h)[0]
    return kernel.gaussian_block_cuda(xa.contiguous(), xb.contiguous(), h)
