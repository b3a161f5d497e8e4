"""ULV-equivalent direct factorization of the shifted HSS matrix.

Counterpart of ``repro.core.factorization`` (local).  The telescoping
inversion (Gillman–Martinsson HBS solver) of K̃_β = K̃ + βI:

  A(ℓ) = D(ℓ) + U(ℓ) A(ℓ−1) U(ℓ)ᵀ          (telescoping form)
  A(ℓ)⁻¹ = G(ℓ) + E(ℓ) (A(ℓ−1) + D̂(ℓ))⁻¹ E(ℓ)ᵀ      with
  D̂ = (Uᵀ D⁻¹ U)⁻¹,   E = D⁻¹ U D̂,   G = D⁻¹ − D⁻¹ U D̂ Uᵀ D⁻¹

O(N r²) to factor once, O(N r) per solve, as batched dense ops per tree
level through ``torch.linalg`` (Cholesky on the SPD leaf blocks, LU on the
reduced levels).  The products are ordinary f32 matmuls: the port keeps
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default), so they
run in full f32 on the card as well.  ``store_dtype="bfloat16"`` stores E
and G in bf16; the solve widens each factor to f32 as it enters its
product, so only the storage rounds.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hss import HSSMatrix


@dataclasses.dataclass(frozen=True)
class HSSFactorization:
    """Factor-once / solve-many artifact for K̃ + beta I."""

    e_leaf: torch.Tensor               # (n_leaf, m, r0)
    g_leaf: torch.Tensor               # (n_leaf, m, m)
    e_lvls: tuple[torch.Tensor, ...]   # per k=1..K-1: (n_k, 2 r_{k-1}, r_k)
    g_lvls: tuple[torch.Tensor, ...]   # per k=1..K-1: (n_k, 2 r_{k-1}, 2 r_{k-1})
    root_lu: torch.Tensor              # (2 r_{K-1}, 2 r_{K-1})
    root_piv: torch.Tensor             # int32, 1-based (LAPACK) pivots
    levels: int
    leaf_size: int
    beta: float

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return hss_solve(self, b)

    def solve_mat(self, b: torch.Tensor) -> torch.Tensor:
        """Solve for multiple RHS, b of shape (N, c) — one block sweep."""
        return hss_solve_mat(self, b)


def _eye_like(d: torch.Tensor) -> torch.Tensor:
    return torch.eye(d.shape[-1], dtype=d.dtype, device=d.device).expand_as(d)


def _regularize(s_hat: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Ŝ + diag(1 − mask).  Dead columns of a masked basis U are exact zeros,
    so Ŝ = Uᵀ D⁻¹ U is structurally singular; a unit diagonal on the dead
    slots makes it [[Ŝ_live, 0], [0, I]], whose inverse keeps the live
    block's D̂ and decouples the dead slots (E's dead columns stay 0)."""
    return s_hat if mask is None else s_hat + torch.diag_embed(1.0 - mask)


def _leaf_factors(d_shift: torch.Tensor, u: torch.Tensor,
                  mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched leaf E, G, D̂ from Cholesky of the shifted diagonal blocks;
    ``mask`` (n_leaf, r) is the adaptive build's skeleton liveness."""
    chol = torch.linalg.cholesky(d_shift)
    dinv_u = torch.cholesky_solve(u, chol)                    # (n, m, r)
    d_hat = torch.linalg.inv(_regularize(u.transpose(1, 2) @ dinv_u, mask))
    e = dinv_u @ d_hat
    dinv = torch.cholesky_solve(_eye_like(d_shift), chol)
    g = dinv - e @ dinv_u.transpose(1, 2)
    return e, g, d_hat


def _level_factors(d_blk: torch.Tensor, u: torch.Tensor,
                   mask: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched reduced-level E, G, D̂ via LU of the (2r x 2r) assembled blocks;
    ``mask`` (n_k, r_k) regularizes the dead parent skeleton slots."""
    lu, piv = torch.linalg.lu_factor(d_blk)
    dinv_u = torch.linalg.lu_solve(lu, piv, u)
    d_hat = torch.linalg.inv(_regularize(u.transpose(1, 2) @ dinv_u, mask))
    e = dinv_u @ d_hat
    dinv = torch.linalg.lu_solve(lu, piv, _eye_like(d_blk))
    g = dinv - e @ dinv_u.transpose(1, 2)
    return e, g, d_hat


def _assemble_next(d_hat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pair children D̂ with their sibling coupling into parent blocks
    [[D̂_c1, B], [Bᵀ, D̂_c2]]: d_hat (n_{k-1}, r, r), b (n_k, r, r) -> (n_k, 2r, 2r)."""
    n_k, r = b.shape[0], b.shape[1]
    pair = d_hat.reshape(n_k, 2, r, r)
    top = torch.cat([pair[:, 0], b], dim=-1)
    bot = torch.cat([b.transpose(-1, -2), pair[:, 1]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def factorize(hss: HSSMatrix, beta: float,
              store_dtype: str | None = None) -> HSSFactorization:
    """Factor K̃ + beta*I once; reused for every ADMM iteration and C value.

    ``store_dtype="bfloat16"`` stores the E/G factors in bf16 (the solve
    accumulates in f32); the root LU stays f32.
    """
    K, m = hss.levels, hss.leaf_size
    d_shift = hss.d_leaf + beta * _eye_like(hss.d_leaf)

    if K == 0:
        # Degenerate single-block problem: dense Cholesky path.
        dtype, dev = hss.d_leaf.dtype, hss.d_leaf.device
        return HSSFactorization(
            e_leaf=torch.zeros((1, m, 0), dtype=dtype, device=dev),
            g_leaf=torch.zeros((1, m, m), dtype=dtype, device=dev),
            e_lvls=(), g_lvls=(),
            root_lu=torch.linalg.cholesky(d_shift[0]),
            root_piv=torch.arange(1, m + 1, dtype=torch.int32, device=dev),
            levels=0, leaf_size=m, beta=beta,
        )

    masks = hss.rank_masks()
    e_leaf, g_leaf, d_hat = _leaf_factors(
        d_shift, hss.u_leaf, None if masks is None else masks[0])
    e_lvls: list[torch.Tensor] = []
    g_lvls: list[torch.Tensor] = []
    for k in range(1, K):
        d_blk = _assemble_next(d_hat, hss.b_mats[k - 1])
        e_k, g_k, d_hat = _level_factors(
            d_blk, hss.transfers[k - 1], None if masks is None else masks[1][k - 1])
        e_lvls.append(e_k)
        g_lvls.append(g_k)
    root = _assemble_next(d_hat, hss.b_mats[K - 1])[0]
    lu, piv = torch.linalg.lu_factor(root)
    if store_dtype is not None:
        sd = getattr(torch, store_dtype)
        e_leaf, g_leaf = e_leaf.to(sd), g_leaf.to(sd)
        e_lvls = [a.to(sd) for a in e_lvls]
        g_lvls = [a.to(sd) for a in g_lvls]
    return HSSFactorization(
        e_leaf=e_leaf, g_leaf=g_leaf,
        e_lvls=tuple(e_lvls), g_lvls=tuple(g_lvls),
        root_lu=lu, root_piv=piv,
        levels=K, leaf_size=m, beta=beta,
    )


def hss_solve(fac: HSSFactorization, b: torch.Tensor) -> torch.Tensor:
    """x = (K̃ + beta I)^{-1} b in O(N r): single-RHS view of the block sweep."""
    return hss_solve_mat(fac, b[:, None])[:, 0]


def hss_solve_mat(fac: HSSFactorization, b: torch.Tensor) -> torch.Tensor:
    """X = (K̃ + beta I)^{-1} B for B (N, c): one upward + one downward sweep,
    the c columns carried as a trailing axis through every level product.

    Every product runs in f32: a bf16-stored factor is widened as it enters
    (``.float()`` is a no-op on f32 factors), as the reference's
    ``preferred_element_type=float32`` contractions promote it.
    """
    K, m = fac.levels, fac.leaf_size
    c = b.shape[1]
    if K == 0:
        return torch.cholesky_solve(b, fac.root_lu)

    n_leaf = fac.e_leaf.shape[0]
    b0 = b.reshape(n_leaf, m, c)
    # Upward sweep: project the RHS through Eᵀ level by level.
    bs = [b0]
    bt = fac.e_leaf.float().transpose(1, 2) @ b0
    for k in range(1, K):
        e_k = fac.e_lvls[k - 1].float()
        b_k = bt.reshape(e_k.shape[0], -1, c)                 # (n_k, 2 r_{k-1}, c)
        bs.append(b_k)
        bt = e_k.transpose(1, 2) @ b_k
    x_root = torch.linalg.lu_solve(fac.root_lu, fac.root_piv, bt.reshape(-1, c))

    # Downward sweep: x_k = G_k b_k + E_k xi_k.
    xi = x_root.reshape(2, -1, c)                             # level K-1 nodes
    for k in range(K - 1, 0, -1):
        x_k = fac.g_lvls[k - 1].float() @ bs[k] + fac.e_lvls[k - 1].float() @ xi
        xi = x_k.reshape(-1, x_k.shape[1] // 2, c)            # children skeleton
    x0 = fac.g_leaf.float() @ b0 + fac.e_leaf.float() @ xi
    return x0.reshape(-1, c)
