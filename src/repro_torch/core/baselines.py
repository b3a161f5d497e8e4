"""Baselines the paper compares against (Tables 2/3) + a kernel-approx rival.

Counterpart of ``repro.core.baselines``:

  * dense_admm — the same closed-form ADMM with the EXACT kernel matrix and
    a dense Cholesky factorization of K + βI (the "ADMM with true kernel"
    reference, RACQP's role in the paper's Table 3).  K is one K1 launch on
    a CUDA device; the factorization and solves are ``torch.linalg`` in f32
    (TF32 stays off).
  * smo — a working-pair Sequential Minimal Optimization solver with
    max-violating-pair selection (LIBSVM's core, Table 2): host numpy with
    an LRU kernel-row cache, as in the reference.
  * nystrom_admm — ADMM with K replaced by a Nyström approximation and the
    shifted solve by Woodbury (paper §1.1's alternative approximation).
    The landmarks are an argument: the reference draws them with
    ``jax.random.choice``, which torch cannot reproduce.

The tensors' device decides where everything runs: K1 (gaussian) or K4
(laplacian) blocks on CUDA tensors, their plain versions on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import admm as admm_mod
from repro_torch.core.kernelfn import KernelSpec, kernel_block


# ---------------------------------------------------------------------- #
# dense-kernel ADMM (RACQP-analogue)                                     #
# ---------------------------------------------------------------------- #
def dense_admm_fit(x: torch.Tensor, y: torch.Tensor, spec: KernelSpec, c_value: float,
                   beta: float, max_it: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (z, bias). O(d³) factorization + O(d²) per iteration.

    Holds K, K + βI and its Cholesky factor at once (3·4d² bytes in f32):
    the bias needs K after the solve.
    """
    k_mat = kernel_block(spec, x, x)
    shifted = k_mat.clone()
    shifted.diagonal().add_(beta)
    chol = torch.linalg.cholesky(shifted)
    del shifted

    def solver(b: torch.Tensor) -> torch.Tensor:
        return torch.cholesky_solve(b[:, None], chol)[:, 0]

    state, _ = admm_mod.admm_svm(solver, y, c_value, beta, max_it)
    del chol
    z = state.z
    return z, _dense_bias(k_mat, y, z, c_value)


def _dense_bias(k_mat: torch.Tensor, y: torch.Tensor, z: torch.Tensor, c_value: float,
                tol: float = 1e-6) -> torch.Tensor:
    on_margin = ((z > tol) & (z < c_value - tol)).to(z.dtype)
    kz = k_mat @ (y * z)
    n_m = on_margin.sum()
    b_margin = -(on_margin @ kz - on_margin @ y) / torch.clamp(n_m, min=1.0)
    sv = (z > tol).to(z.dtype)
    b_all = -(sv @ kz - sv @ y) / torch.clamp(sv.sum(), min=1.0)
    return torch.where(n_m > 0, b_margin, b_all)


def dense_predict(x_train: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  bias: torch.Tensor | float, spec: KernelSpec,
                  x_test: torch.Tensor) -> torch.Tensor:
    scores = kernel_block(spec, x_test, x_train) @ (y * z) + bias
    return torch.where(scores >= 0, 1, -1)


# ---------------------------------------------------------------------- #
# SMO (LIBSVM-analogue), host implementation                             #
# ---------------------------------------------------------------------- #
def smo_fit(
    x: np.ndarray, y: np.ndarray, spec: KernelSpec, c_value: float,
    tol: float = 1e-3, max_iter: int = 20000,
) -> tuple[np.ndarray, float, int]:
    """Max-violating-pair SMO on the dual. Returns (alpha, bias, iters)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    sq = (x * x).sum(1)

    cache: dict[int, np.ndarray] = {}

    def krow(i: int) -> np.ndarray:
        if i not in cache:
            if len(cache) > 2048:
                cache.pop(next(iter(cache)))
            d2 = np.maximum(sq[i] + sq - 2.0 * (x @ x[i]), 0.0)
            cache[i] = np.exp(-d2 / (2.0 * spec.h * spec.h))
        return cache[i]

    alpha = np.zeros(n)
    grad = -np.ones(n)          # G = ∇(½aᵀQa − eᵀa) = Qa − e,  Q = Y K Y
    it = 0
    for it in range(max_iter):
        # LIBSVM WSS1: i = argmax_{I_up} −y G;  j = argmin_{I_low} −y G
        up = ((alpha < c_value - 1e-12) & (y > 0)) | ((alpha > 1e-12) & (y < 0))
        lo = ((alpha < c_value - 1e-12) & (y < 0)) | ((alpha > 1e-12) & (y > 0))
        if not up.any() or not lo.any():
            break
        myg = -y * grad
        i = int(np.argmax(np.where(up, myg, -np.inf)))
        j = int(np.argmin(np.where(lo, myg, np.inf)))
        gap = myg[i] - myg[j]
        if gap < tol:
            break
        ki, kj = krow(i), krow(j)
        # a = Q_ii + Q_jj − 2 y_i y_j K_ij
        quad = max(ki[i] + kj[j] - 2.0 * y[i] * y[j] * ki[j], 1e-12)
        t = gap / quad           # step in the (y_i α_i, −y_j α_j) direction
        # box clipping preserving yᵀα: Δα_i = +y_i t, Δα_j = −y_j t
        if y[i] > 0:
            t = min(t, c_value - alpha[i])
        else:
            t = min(t, alpha[i])
        if y[j] > 0:
            t = min(t, alpha[j])
        else:
            t = min(t, c_value - alpha[j])
        t = max(t, 0.0)
        dai = y[i] * t
        daj = -y[j] * t
        alpha[i] += dai
        alpha[j] += daj
        # G += Q[:, i] Δα_i + Q[:, j] Δα_j,  Q[:, t] = y ⊙ K[:, t] y_t
        grad += y * (ki * (y[i] * dai) + kj * (y[j] * daj))
    # bias from margin SVs
    on_m = (alpha > 1e-8) & (alpha < c_value - 1e-8)
    ya = y * alpha
    if on_m.any():
        idx = np.where(on_m)[0][:256]
        scores = np.array([krow(int(i)) @ ya for i in idx])
        b = float(np.mean(y[idx] - scores))
    else:
        b = 0.0
    return alpha, b, it + 1


# ---------------------------------------------------------------------- #
# Nyström + ADMM (Woodbury shifted solve)                                #
# ---------------------------------------------------------------------- #
def nystrom_landmarks(n: int, n_landmarks: int = 256, seed: int = 0) -> np.ndarray:
    """``min(n_landmarks, n)`` distinct row indices drawn by
    ``np.random.default_rng(seed)``."""
    return np.random.default_rng(seed).choice(n, min(n_landmarks, n), replace=False)


def nystrom_admm_fit(
    x: torch.Tensor, y: torch.Tensor, spec: KernelSpec, c_value: float, beta: float,
    n_landmarks: int = 256, max_it: int = 10, seed: int = 0,
    landmarks: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K ≈ Z Zᵀ (Z = K(X,L) W^{-1/2}); (βI + ZZᵀ)^{-1} via Woodbury.

    ``landmarks`` are the rows of L; None draws ``nystrom_landmarks(n,
    n_landmarks, seed)``.
    """
    if landmarks is None:
        landmarks = nystrom_landmarks(x.shape[0], n_landmarks, seed)
    xl = x[torch.tensor(np.asarray(landmarks), dtype=torch.long, device=x.device)]
    w = kernel_block(spec, xl, xl)
    evals, evecs = torch.linalg.eigh(w)
    inv_sqrt = torch.where(evals > 1e-8, 1.0 / torch.sqrt(torch.clamp(evals, min=1e-8)),
                           torch.zeros_like(evals))
    w_isqrt = (evecs * inv_sqrt) @ evecs.T
    z_mat = kernel_block(spec, x, xl) @ w_isqrt          # (n, k)
    k_small = z_mat.T @ z_mat
    shifted = k_small + beta * torch.eye(z_mat.shape[1], dtype=x.dtype, device=x.device)
    chol = torch.linalg.cholesky(shifted)

    def solver(b: torch.Tensor) -> torch.Tensor:
        t = torch.cholesky_solve((z_mat.T @ b)[:, None], chol)[:, 0]
        return (b - z_mat @ t) / beta

    state, _ = admm_mod.admm_svm(solver, y, c_value, beta, max_it)
    z = state.z
    # bias with the approximate kernel (one matvec through the factors)
    kz = z_mat @ (z_mat.T @ (y * z))
    on_margin = ((z > 1e-6) & (z < c_value - 1e-6)).to(z.dtype)
    n_m = on_margin.sum()
    bias = -(on_margin @ kz - on_margin @ y) / torch.clamp(n_m, min=1.0)
    return z, bias
