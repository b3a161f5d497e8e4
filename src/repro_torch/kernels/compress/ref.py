"""Plain PyTorch version of the fused assemble + pivoted-QR stage (gaussian)."""
from __future__ import annotations

import torch

from repro_torch.core import idqr
from repro_torch.kernels.gaussian.ref import gaussian_block_ref


def fused_assemble_id_ref(xc: torch.Tensor, xp: torch.Tensor, cmask: torch.Tensor,
                          k: int, h: float) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, m, f), xp (B, s, f), cmask (B, m) -> (piv (B, k) int32, R (B, k, m)).

    Assembles Aᵀ = K(xp, xc) with dead candidates (cmask = 0) zeroed, runs
    the k greedy CPQR steps of ``idqr.cpqr_select`` on it and returns the
    pivots with R = QᵀAᵀ — the inputs of ``idqr.finish_interp``.
    """
    a_t = (gaussian_block_ref(xc, xp, h) * cmask[:, :, None]).transpose(1, 2)
    piv, qs = idqr.cpqr_select(a_t, k)
    return piv, qs.transpose(1, 2) @ a_t
