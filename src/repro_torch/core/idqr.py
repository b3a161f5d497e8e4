"""Interpolative decomposition via greedy column-pivoted QR, in torch.

Counterpart of ``repro.core.idqr``.  Selects ``k`` skeleton columns J of
M (s, n) and an interpolation matrix T (k, n) with  M ≈ M[:, J] @ T  and
T[:, J] = I.  Every function takes a leading batch of matrices (…, s, n)
where the JAX package vmapped over nodes; a plain (s, n) matrix works too.

``interp_decomp`` is the fixed-rank ID; ``interp_decomp_ranked`` detects
each matrix's numerical rank from the pivoted-QR diagonal decay against a
tolerance (the adaptive-rank build).
"""
from __future__ import annotations

import torch


def cpqr_select(m_mat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy CPQR pivot selection.

    Returns (piv (…, k) int32 column indices, qmat (…, s, k) orthonormal
    basis of the selected columns' span).  Modified Gram-Schmidt with an
    explicit re-orthogonalisation against the earlier directions; argmax
    ties break to the lowest index, as ``jnp.argmax`` does.
    """
    *batch, s, n = m_mat.shape
    resid = m_mat.reshape(-1, s, n).clone()
    nb = resid.shape[0]
    rows = torch.arange(nb, device=m_mat.device)
    piv = torch.zeros((nb, k), dtype=torch.int64, device=m_mat.device)
    qs = torch.zeros((nb, s, k), dtype=m_mat.dtype, device=m_mat.device)
    avail = torch.ones((nb, n), dtype=torch.bool, device=m_mat.device)
    for i in range(k):
        norms = torch.where(avail, (resid * resid).sum(1), -1.0)
        p = torch.argmax(norms, dim=1)
        col = resid[rows, :, p]                                   # (nb, s)
        q = col / torch.sqrt(torch.clamp(norms[rows, p], min=1e-30))[:, None]
        # "Twice is enough": re-orthogonalise against prior directions.
        q = q - (qs @ (qs.transpose(1, 2) @ q[:, :, None]))[:, :, 0]
        q = q / torch.sqrt(torch.clamp((q * q).sum(1), min=1e-30))[:, None]
        # Deflate every column, then zero the chosen one exactly.
        resid = resid - q[:, :, None] * (q[:, None, :] @ resid)
        resid[rows, :, p] = 0.0
        piv[:, i] = p
        qs[:, :, i] = q
        avail[rows, p] = False         # pivots stay distinct on all-zero blocks
    return (piv.to(torch.int32).reshape(*batch, k),
            qs.reshape(*batch, s, k))


def finish_interp(piv: torch.Tensor, r_full: torch.Tensor, rtol: float,
                  keep_identity: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncation + triangular solve from (piv, R = QᵀM): returns (T, rank).

    piv (…, k), r_full (…, k, n).  R_J = R[:, J] is upper triangular in pivot
    order, so T = R_J⁻¹ R.  The greedy pivoting makes |R_J[i, i]|
    non-increasing, so its decay against ``rtol · max|diag|`` reveals the
    numerical rank.  Truncated directions get a unit diagonal and a zeroed
    row, which keeps the solve exact and finite on rank-deficient blocks.

    ``keep_identity=True`` (fixed rank) truncates direction by direction and
    sets T[:, J] = I on all k skeleton columns.  ``keep_identity=False``
    (adaptive) keeps the longest prefix of directions above the tolerance
    (``rank``), sets the identity on the live skeleton columns only — a
    truncated pivot keeps its interpolation weights over the live skeletons
    — and zeroes every row ≥ rank of T, so those columns of the basis can be
    masked and later sliced away without changing any live value.
    """
    *batch, k, n = r_full.shape
    r2 = r_full.reshape(-1, k, n)
    p2 = piv.reshape(-1, k).long()
    nb = r2.shape[0]
    piv_cols = p2[:, None, :].expand(nb, k, k)
    r_skel = torch.triu(torch.gather(r2, 2, piv_cols))
    diag = torch.diagonal(r_skel, dim1=1, dim2=2)
    tol = rtol * torch.clamp(diag.abs().amax(1, keepdim=True), min=1e-30)
    above = diag.abs() > tol
    # Prefix rank (adaptive): everything after the first below-tolerance
    # direction is dead, so the live directions are a leading block.
    keep = above if keep_identity else torch.cumsum(~above, dim=1) == 0
    r_safe = (torch.where(keep[:, :, None], r_skel, 0.0)
              + torch.diag_embed(torch.where(keep, 0.0, 1.0).to(r2.dtype)))
    rhs = torch.where(keep[:, :, None], r2, 0.0)
    t_full = torch.linalg.solve_triangular(r_safe, rhs, upper=True)
    eye = torch.eye(k, dtype=r2.dtype, device=r2.device).expand(nb, k, k)
    if keep_identity:
        t_full = t_full.scatter(2, piv_cols, eye)
    else:
        at_piv = torch.gather(t_full, 2, piv_cols)
        t_full = t_full.scatter(2, piv_cols, torch.where(keep[:, None, :], eye, at_piv))
        t_full = t_full * keep[:, :, None].to(r2.dtype)
    rank = keep.sum(1).to(torch.int32)
    return t_full.reshape(*batch, k, n), rank.reshape(batch)


def _interp_core(m_mat: torch.Tensor, k: int, rtol: float, keep_identity: bool
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pivoted QR, then ``finish_interp``.  Returns (piv, T, rank)."""
    piv, qs = cpqr_select(m_mat, k)
    r_full = qs.transpose(-1, -2) @ m_mat                     # (…, k, n)
    t_full, rank = finish_interp(piv, r_full, rtol, keep_identity)
    return piv, t_full, rank


def interp_decomp(m_mat: torch.Tensor, k: int, rtol: float = 1e-5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Column ID:  M ≈ M[:, J] @ T  with  T[:, J] = I_k (fixed rank)."""
    piv, t_full, _ = _interp_core(m_mat, k, rtol, keep_identity=True)
    return piv, t_full


def interp_decomp_ranked(m_mat: torch.Tensor, k: int, rtol: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adaptive column ID: (piv, T, rank) with rows ≥ rank of T exactly 0.

    k stays the cap, so shapes never depend on the data; T[:, J] = I on the
    first ``rank`` skeleton columns.
    """
    return _interp_core(m_mat, k, rtol, keep_identity=False)


def row_interp_decomp(m_mat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row ID:  M ≈ P @ M[J, :]  with P (rows, k), P[J, :] = I_k."""
    piv, t = interp_decomp(m_mat.transpose(-1, -2), k)
    return piv, t.transpose(-1, -2)


def row_interp_decomp_ranked(m_mat: torch.Tensor, k: int, rtol: float = 1e-5
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adaptive row ID: M ≈ P @ M[J, :] with P's columns ≥ rank exactly 0."""
    piv, t, rank = interp_decomp_ranked(m_mat.transpose(-1, -2), k, rtol)
    return piv, t.transpose(-1, -2), rank
