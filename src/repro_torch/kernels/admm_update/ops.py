"""Public wrapper of the fused ADMM z/μ update."""
from __future__ import annotations

import torch

from repro_torch.kernels.admm_update import kernel, ref


def fused_zmu_update(x: torch.Tensor, mu: torch.Tensor, c_vec: torch.Tensor,
                     beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """z = clip(x − μ/β, 0, c), μ⁺ = μ − β(x − z) over flat vectors.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if x.device.type == "cpu":
        return ref.fused_zmu_update_ref(x, mu, c_vec, beta)
    return kernel.fused_zmu_update_cuda(
        x.contiguous(), mu.contiguous(), c_vec.contiguous(), beta)
