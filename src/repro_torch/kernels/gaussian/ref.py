"""Plain PyTorch Gaussian kernel block (twin of ``kernelfn.gaussian_block_xla``)."""
from __future__ import annotations

import torch


def gaussian_block_ref(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """exp(-max(|a|² + |b|² - 2abᵀ, 0) / 2h²) for (..., Ma, F) x (..., Mb, F).

    Norms, cross term and exp run in f32 whatever the input type; the block
    comes back in the input type.
    """
    a, b = xa.float(), xb.float()
    na = (a * a).sum(-1)[..., :, None]
    nb = (b * b).sum(-1)[..., None, :]
    cross = a @ b.transpose(-1, -2)
    sq = torch.clamp(na + nb - 2.0 * cross, min=0.0)
    return torch.exp(sq * (-0.5 / (h * h))).to(
        torch.promote_types(xa.dtype, xb.dtype))
