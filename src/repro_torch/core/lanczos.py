"""Lanczos on the O(N r) HSS matvec: leading eigenpairs + spectral embedding.

Counterpart of ``repro.core.lanczos``.  m Lanczos steps with full
reorthogonalization give the leading eigenpairs of K̃ at O(m · N r)
operator cost: the trained compression becomes a kernel-PCA / spectral
feature extractor.  The JAX ``lax.scan`` over a fixed basis block is a
Python loop over the same (m + 1, n) block here.  The start vector ``v0`` is
an argument; without one a seeded ``torch.Generator`` draws it.

Padded datasets (``tree.pad_dataset``): the pad block of K̃ is ≈ I, so pads
contribute a cluster of eigenvalues ≈ 1; keep k below the number of data
eigenvalues above 1, or read the embedding through
``HSSSVMEngine.spectral_embed``, which drops pad rows.

On a node-split HSS matrix (``hss.mesh``) the basis holds the rank's rows
and each dot product and norm is a local partial plus one all-reduce;
``v0`` stays an argument of full length, and each rank takes its rows.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist import api as dist_api

# Below this residual norm the Krylov space is exhausted (lucky breakdown):
# the next basis vector is zeroed instead of amplifying float noise.
_BREAKDOWN = 1e-30


def lanczos(matvec: Callable[[torch.Tensor], torch.Tensor], v0: torch.Tensor,
            num_iters: int, mesh=None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_iters`` Lanczos steps with FULL reorthogonalization.

    Returns ``(alphas (m,), betas (m,), basis (m+1, n))`` with the symmetric
    tridiagonal T = diag(alphas) + offdiag(betas[:m-1]); ``betas[m-1]`` is
    the final residual norm.  All in f32; each step runs a double
    Gram-Schmidt against the whole stored basis (rows not yet written are
    zero and contribute nothing).  ``mesh``: ``v0``, ``matvec`` and the
    basis are the rank's rows, the inner products summed over ranks.
    """
    def psum(t):
        return dist_api.all_reduce_sum(t, mesh)

    n = v0.shape[0]
    v0 = v0.float()
    basis = torch.zeros((num_iters + 1, n), dtype=torch.float32, device=v0.device)
    basis[0] = v0 / _norm(v0, mesh)
    alphas = torch.zeros(num_iters, dtype=torch.float32, device=v0.device)
    betas = torch.zeros(num_iters, dtype=torch.float32, device=v0.device)
    for i in range(num_iters):
        v = basis[i]
        w = matvec(v).float()
        alphas[i] = psum(v @ w)
        for _ in range(2):            # double Gram-Schmidt vs the full basis
            w = w - basis.T @ psum(basis @ w)
        b = _norm(w, mesh)
        basis[i + 1] = torch.where(b > _BREAKDOWN, w / torch.clamp(b, min=_BREAKDOWN),
                                   torch.zeros_like(w))
        betas[i] = b
    return alphas, betas, basis


def _norm(v: torch.Tensor, mesh) -> torch.Tensor:
    """2-norm of a vector; under a mesh of the ranks' rows together."""
    if mesh is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(dist_api.all_reduce_sum(v @ v, mesh))


def tridiag_eigh(alphas: torch.Tensor, offdiag: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """eigh of the (m, m) symmetric tridiagonal (ascending eigenvalues)."""
    t = torch.diag(alphas) + torch.diag(offdiag, 1) + torch.diag(offdiag, -1)
    return torch.linalg.eigh(t)


def default_iters(n: int, k: int) -> int:
    """Default Krylov depth: comfortably past k, capped by the problem size."""
    return min(n, max(2 * k + 10, 3 * k))


def start_vector(n: int, device, seed: int = 0) -> torch.Tensor:
    """A standard-normal (n,) f32 start vector from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, device=device)


def top_eigenpairs(hss, k: int, num_iters: int | None = None,
                   v0: torch.Tensor | None = None, seed: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Leading k eigenpairs of K̃ via Lanczos on ``hss.matvec``.

    Returns ``(eigenvalues (k,) descending, vectors (n, k))`` in the
    permuted/padded row order of ``hss.x``.  ``v0`` (n,) starts the Krylov
    space (moved to ``hss.x``'s device); without it ``start_vector(n,
    seed=seed)`` does.  On a node-split ``hss`` the vectors are the rank's
    rows (``v0`` and the drawn start stay of full length).
    """
    n = hss.n_total
    m = num_iters if num_iters is not None else default_iters(n, k)
    if not 0 < k <= m:
        raise ValueError(f"need 0 < k <= num_iters, got k={k}, m={m}")
    v0 = (start_vector(n, hss.x.device, seed) if v0 is None
          else torch.as_tensor(v0, device=hss.x.device))
    alphas, betas, basis = lanczos(hss.matvec, dist_api.local_rows(v0, hss.mesh), m,
                                   mesh=hss.mesh)
    evals, evecs = tridiag_eigh(alphas, betas[:-1])
    top = torch.argsort(evals, descending=True)[:k]
    return evals[top], basis[:m].T @ evecs[:, top]


def lowest_eigenvalue(hss) -> tuple[float, float]:
    """K̃'s least eigenvalue as 120 Lanczos steps on ``hss.matvec`` find it:
    (θ, ρ), the smallest Ritz value and its residual norm |K̃v − θv| for the
    unit Ritz vector v.  θ never lies below the least eigenvalue λ_min, and
    some eigenvalue lies within ρ of θ; once the Ritz value has converged to
    the extreme eigenvalue (Lanczos finds the ends of the spectrum first),
    λ_min ∈ [θ − ρ, θ].  A compressed K̃ of a positive-definite kernel can
    be indefinite; this reads by how much."""
    n, mesh = hss.n_total, hss.mesh
    m = min(n, 120)
    alphas, betas, basis = lanczos(
        hss.matvec, dist_api.local_rows(start_vector(n, hss.x.device), mesh), m, mesh=mesh)
    evals, evecs = tridiag_eigh(alphas, betas[:-1])
    v = basis[:m].T @ evecs[:, 0]
    v = v / _norm(v, mesh)
    theta = float(evals[0])
    return theta, float(_norm(hss.matvec(v).float() - theta * v, mesh))


def spectral_embed(hss, k: int, num_iters: int | None = None,
                   v0: torch.Tensor | None = None, seed: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-PCA coordinates (n, k), eigenvectors scaled by √eigenvalue,
    and the eigenvalues (k,), in permuted/padded row order."""
    evals, vecs = top_eigenpairs(hss, k, num_iters=num_iters, v0=v0, seed=seed)
    return vecs * torch.sqrt(torch.clamp(evals, min=0.0))[None, :], evals
