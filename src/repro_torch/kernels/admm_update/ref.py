"""Plain PyTorch ADMM z/μ update (paper Alg. 2 lines 3-4)."""
from __future__ import annotations

import torch


def fused_zmu_update_ref(x: torch.Tensor, mu: torch.Tensor, c_vec: torch.Tensor,
                         beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    z = torch.minimum(torch.clamp(x - mu / beta, min=0.0), c_vec)
    return z, mu - beta * (x - z)
