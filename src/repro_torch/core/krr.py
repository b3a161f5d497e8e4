"""KRR and the GP posterior mean as ONE multi-RHS solve on the HSS factorization.

Counterpart of ``repro.core.krr``:

  KRR:   α = (K̃ + λI)⁻¹ y,     f(x) = Σ αᵢ K(xᵢ, x)
  GP:    the same mean (λ = noise σ²); model selection adds the log marginal
           log p(y) = −½ yᵀα − ½ log det(K̃ + λI) − (n/2) log 2π
         whose log det is estimated by Hutchinson probes with Lanczos
         (Gauss) quadrature on the O(N r) matvec.

λ rides the factorization's β shift slot (``HSSSVMEngine._fac_for`` caches
one factorization per visited λ), and the model scores through
``kernel_matvec_streamed`` like every other task.  The Hutchinson probes are
an argument; without them a seeded ``torch.Generator`` draws them.  On a
node-split HSS matrix ``y``, ``mask`` and the solves are the rank's rows,
the probes stay of full length (each rank takes its rows), and every sum
over the samples is a local partial plus one all-reduce.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.lanczos import lanczos, tridiag_eigh
from repro_torch.dist import api as dist_api
from repro_torch.core.tasks import svr_score as krr_score   # negated RMSE


def krr_solve(fac, targets: torch.Tensor) -> torch.Tensor:
    """α = (K̃ + λI)⁻¹ Y for target columns Y (d, P); λ is ``fac.beta``."""
    return fac.solve_mat(targets)


def rademacher_probes(n_probes: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """(n_probes, n) ±1 f32 probes from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 2, (n_probes, n), generator=gen, device=device).float() * 2 - 1


def gp_log_marginal(hss, fac, y: torch.Tensor, mask: torch.Tensor | None = None,
                    n_probes: int = 4, num_iters: int = 20,
                    probes: torch.Tensor | None = None, seed: int = 0) -> float:
    """Hutchinson + Lanczos-quadrature estimate of the GP log marginal.

    The data-fit term −½ yᵀ(K̃ + λI)⁻¹y is exact (one solve); log det is
    estimated from ``probes`` (n_probes, n) of ±1 (``rademacher_probes`` with
    ``seed`` when None), each integrated by a ``num_iters``-point Gauss
    quadrature from the Lanczos tridiagonal of the shifted matvec.  ``mask``
    (1 real / 0 pad) removes the pad block's n_pad · log(1 + λ) and counts
    only real points in the 2π term.
    """
    mesh = hss.mesh
    y = torch.as_tensor(y, dtype=torch.float32).reshape(-1)
    n = hss.n_total
    lam = float(fac.beta)
    alpha = fac.solve_mat(y[:, None])[:, 0]
    fit = -0.5 * float(dist_api.all_reduce_sum(y @ alpha, mesh))

    def matvec(v):
        return hss.matvec(v) + lam * v

    probes = (rademacher_probes(n_probes, n, y.device, seed) if probes is None
              else torch.as_tensor(probes, device=y.device))
    logdet = 0.0
    for z in probes:
        alphas, betas, _ = lanczos(matvec, dist_api.local_rows(z, mesh), num_iters,
                                   mesh=mesh)
        theta, u = tridiag_eigh(alphas, betas[:-1])
        w = u[0, :] ** 2                     # Gauss weights: (e₁ᵀuᵢ)²
        quad = float(w @ torch.log(torch.clamp(theta, min=1e-12)))
        logdet += float(n) * quad            # ‖z‖² = n for ±1 probes
    logdet /= probes.shape[0]

    n_eff = n
    if mask is not None:
        n_real = int(float(dist_api.all_reduce_sum(torch.as_tensor(mask).sum(), mesh)))
        logdet -= (n - n_real) * math.log1p(lam)
        n_eff = n_real
    return fit - 0.5 * logdet - 0.5 * n_eff * math.log(2.0 * math.pi)


def grid_search_krr(x: np.ndarray, y: np.ndarray, x_val: np.ndarray, y_val: np.ndarray,
                    hs: Sequence[float], lams: Sequence[float],
                    trainer_kwargs: dict | None = None, rtol: float | None = None
                    ) -> tuple[object, dict]:
    """(h, λ) grid for KRR: per h ONE compression serves the λ sweep (one
    refactorization and one solve per λ), scored by negated validation RMSE."""
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import resolve_rtol, run_grid_search

    kw = resolve_rtol(trainer_kwargs, rtol)
    return run_grid_search(
        lambda h: HSSSVMEngine(spec=KernelSpec(h=h), task="krr", **kw),
        x, y, x_val, y_val, hs, lams, score_fn=krr_score)


def grid_search_gp(x: np.ndarray, y: np.ndarray, hs: Sequence[float],
                   lams: Sequence[float], trainer_kwargs: dict | None = None,
                   rtol: float | None = None, n_probes: int = 4, num_iters: int = 20,
                   seed: int = 0) -> tuple[object, dict]:
    """(h, λ) grid for GP regression scored by the TRAINING log marginal
    (no validation split).  Returns the best posterior-mean model and the
    per-(h, λ) scores with the winning pair."""
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import resolve_rtol

    kw = resolve_rtol(trainer_kwargs, rtol)
    results: dict = {}
    best_model, best_key, best_score = None, None, -math.inf
    for h in hs:
        engine = HSSSVMEngine(spec=KernelSpec(h=float(h)), task="gp", **kw)
        engine.prepare(x, y)
        for lam in lams:
            model, _ = engine.train(float(lam))
            score = engine.log_marginal(float(lam), n_probes=n_probes,
                                        num_iters=num_iters, seed=seed)
            results[(float(h), float(lam))] = dict(log_marginal=score)
            if score > best_score:
                best_model, best_key, best_score = model, (h, lam), score
    return best_model, dict(results=results, best_h=float(best_key[0]),
                            best_lam=float(best_key[1]), best_log_marginal=best_score)
