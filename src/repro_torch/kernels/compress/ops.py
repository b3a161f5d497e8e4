"""Public wrapper of the fused assemble + ID stage of one tree level.

The kernel (or, for CPU tensors, its plain version) returns the pivots and
the projected factor R = QᵀAᵀ; the ``idqr.finish_interp`` tail — a small
batched triangular solve — stays in torch, as in ``repro.kernels.compress``.
"""
from __future__ import annotations

import torch

from repro_torch.core import idqr
from repro_torch.kernels.compress import kernel, ref


def batched_assemble_id(
    xc: torch.Tensor,
    xp: torch.Tensor,
    k: int,
    *,
    h: float,
    rtol: float,
    kernel_name: str = "gaussian",
    adaptive: bool = False,
    cmask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All row IDs of one tree level.

    xc (B, m, f) candidate points, xp (B, s, f) proxy points, cmask (B, m)
    candidate liveness (all ones when None).  Returns (piv (B, k) int32,
    p_mat (B, m, k), ranks (B,) int32): per node the
    ``idqr.row_interp_decomp(_ranked)`` of the sampled block K(xc_i, xp_i),
    which is never written to device memory on the card.
    ``adaptive=False`` keeps the fixed-rank identity on all k skeleton
    columns; ``adaptive=True`` zeroes the columns past each node's rank.
    """
    if cmask is None:
        cmask = torch.ones(xc.shape[:2], dtype=torch.float32, device=xc.device)
    if xc.device.type == "cpu":
        piv, r_full = ref.fused_assemble_id_ref(xc, xp, cmask, k, h, kernel_name)
    else:
        piv, r_full = kernel.fused_assemble_id_cuda(
            xc.contiguous(), xp.contiguous(), cmask.contiguous(), k, h, kernel_name)
    t_full, ranks = idqr.finish_interp(piv, r_full, rtol,
                                       keep_identity=not adaptive)
    return piv, t_full.transpose(1, 2).to(xc.dtype), ranks
