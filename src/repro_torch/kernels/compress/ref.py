"""Plain PyTorch versions of the compression kernels: the laplacian block
(K4) and the fused assemble + pivoted-QR stage (K2), both kernels."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import idqr
from repro_torch.kernels.gaussian.ref import gaussian_block_ref


def l1_dist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||_1 for (..., Ma, F) x (..., Mb, F) f32 -> (..., Ma, Mb).

    Summed one feature at a time in feature order, in f32: the order of the
    CUDA kernels' loops, so kernel and plain version give the same sums.
    """
    d1 = (a[..., :, None, 0] - b[..., None, :, 0]).abs_()
    for c in range(1, a.shape[-1]):
        d1 += (a[..., :, None, c] - b[..., None, :, c]).abs_()
    return d1


def laplacian_block_ref(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """exp(-||a - b||_1 · f32(1/h)) for (..., Ma, F) x (..., Mb, F).

    The numerics of the reference's Pallas tile (``_laplacian_tile``): the
    L1 distance in f32 whatever the input type, times f32(1/h); the block
    comes back in the input type.
    """
    neg_inv_h = -float(np.float32(1.0 / h))
    d1 = l1_dist_ref(xa.float(), xb.float())
    return torch.exp(d1.mul_(neg_inv_h)).to(torch.promote_types(xa.dtype, xb.dtype))


def _assemble(xc: torch.Tensor, xp: torch.Tensor, h: float, kernel_name: str
              ) -> torch.Tensor:
    """K(xc, xp) (B, m, s) in f32, as the reference's fused kernel builds it."""
    if kernel_name == "laplacian":
        # exp(-d1 / h) with a true division, as ``_assemble_laplacian`` has
        # it.  The divisor is a 0-dim tensor on the block's device: PyTorch
        # turns division by a Python scalar into a product with its
        # reciprocal on the card.
        d1 = l1_dist_ref(xc.float(), xp.float())
        return torch.exp(torch.div(-d1, d1.new_full((), h)))
    return gaussian_block_ref(xc, xp, h)


def fused_assemble_id_ref(xc: torch.Tensor, xp: torch.Tensor, cmask: torch.Tensor,
                          k: int, h: float, kernel_name: str = "gaussian"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, m, f), xp (B, s, f), cmask (B, m) -> (piv (B, k) int32, R (B, k, m)).

    Assembles Aᵀ = K(xp, xc) with dead candidates (cmask = 0) zeroed, runs
    the k greedy CPQR steps of ``idqr.cpqr_select`` on it and returns the
    pivots with R = QᵀAᵀ — the inputs of ``idqr.finish_interp``.
    """
    a_t = (_assemble(xc, xp, h, kernel_name) * cmask[:, :, None]).transpose(1, 2)
    piv, qs = idqr.cpqr_select(a_t, k)
    return piv, qs.transpose(1, 2) @ a_t
