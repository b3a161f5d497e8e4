"""ε-SVR and one-class SVM as BoxQPTask specs on the shared K_β⁻¹.

Counterpart of ``repro.core.tasks``.  The shifted kernel K̃ + βI depends
only on the data, h and β, never on the task, so both ride the SVM's HSS
compression and factorization:

  ε-SVR (difference form, α = α⁺ − α⁻):
      min ½ αᵀKα − yᵀα + ε‖α‖₁   s.t. eᵀα = 0,  α ∈ [−C, C]^d
    the ℓ1 term handled exactly by the z-step's soft-threshold prox;
    f(x) = Σ αᵢ K(xᵢ, x) + b.

  one-class SVM (Schölkopf ν):
      min ½ αᵀKα   s.t. eᵀα = 1,  α ∈ [0, 1/(νn)]^d
    f(x) = Σ αᵢ K(xᵢ, x) − ρ, ≥ 0 on the estimated support of the data.

Each bias/offset extraction costs ONE HSS matmat, batched over problem
columns; the column sums accumulate in f32.  Pads are pinned to the [0, 0]
box through the participation mask, as in classification.  On a node-split
HSS matrix the blocks are the rank's rows and the sums local partials
summed by one all-reduce.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.admm import BoxQPTask, box_matrix
from repro_torch.core.hss import HSSMatrix
from repro_torch.dist import api as dist_api


def _rows(a) -> torch.Tensor:
    """(k, d) rows from a (d,) vector or a (k, d) matrix."""
    t = torch.as_tensor(a)
    return t[None, :] if t.dim() == 1 else t


def svr_task(targets: torch.Tensor, c_box: torch.Tensor | float,
             epsilon: torch.Tensor | float) -> BoxQPTask:
    """ε-SVR difference-form dual for k regression problems.

    ``targets`` (k, d) or (d,); ``c_box`` a scalar or (k, d) bound (pass
    C·mask so pads get the inert [0, 0] box); ``epsilon`` scalar or (k,).
    """
    t = _rows(targets)
    k, d = t.shape
    kw = dict(dtype=t.dtype, device=t.device)
    c_mat = box_matrix(c_box, d, k, t.dtype, t.device)
    return BoxQPTask(
        sign=torch.ones((d, k), **kw),
        lin=-t.T,
        lo=-c_mat,
        hi=c_mat,
        eq_sa=torch.ones((d,), **kw),
        eq_b=None,
        l1=torch.as_tensor(epsilon, **kw).expand(k),
    )


def one_class_task(mask: torch.Tensor, nu: torch.Tensor | float,
                   n_real: torch.Tensor | None = None) -> BoxQPTask:
    """Schölkopf ν one-class SVM for k problems.

    ``mask`` (k, d) or (d,) participation masks (1 real, 0 pad): the box
    upper bound is mask/(ν·n_real), so pads are pinned to [0, 0] and the
    mass eᵀα = 1 lives on real points.  ``n_real`` (k,): the real points
    of each problem, ``mask``'s row sums unless given (under a mesh the
    sum over every rank's rows).
    """
    m = _rows(mask)
    k, d = m.shape
    kw = dict(dtype=m.dtype, device=m.device)
    n_real = m.sum(1) if n_real is None else n_real
    nu_arr = torch.as_tensor(nu, **kw).expand(k)
    return BoxQPTask(
        sign=torch.ones((d, k), **kw),
        lin=torch.zeros((d, k), **kw),
        lo=torch.zeros((d, k), **kw),
        hi=m.T / (nu_arr * n_real)[None, :],
        eq_sa=torch.ones((d,), **kw),
        eq_b=torch.ones((k,), **kw),
        l1=None,
    )


def _colsum(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_d mask·v per column, accumulated in f32."""
    return (mask.float() * v.float()).sum(0)


def compute_bias_svr_batched(hss: HSSMatrix, targets: torch.Tensor,
                             alpha: torch.Tensor, c_mat: torch.Tensor,
                             masks: torch.Tensor, epsilon: torch.Tensor | float,
                             margin_rel: float = 1e-4) -> torch.Tensor:
    """SVR bias from the margin SVs (0 < |αᵢ| < C), ONE HSS matmat for all P.

    b averages yᵢ − (K̃α)ᵢ − ε·sign(αᵢ) over the margin SVs; falls back to
    all SVs, then to all real points (ε term dropped).  Blocks are (d, P);
    returns (P,).
    """
    k_alpha = hss.matmat(alpha)
    absa = alpha.abs()
    tol = margin_rel * c_mat
    resid = targets - k_alpha - epsilon * torch.sign(alpha)
    on_margin = ((absa > tol) & (absa < c_mat - tol) & (masks > 0)).to(alpha.dtype)
    sv = ((absa > tol) & (masks > 0)).to(alpha.dtype)
    sums = torch.stack([on_margin.sum(0).float(), _colsum(on_margin, resid),
                        sv.sum(0).float(), _colsum(sv, resid),
                        _colsum(masks, targets - k_alpha), masks.sum(0).float()])
    n_m, r_m, n_sv, r_sv, r_all, n_all = dist_api.all_reduce_sum(sums, hss.mesh)
    b_margin = r_m / torch.clamp(n_m, min=1.0)
    b_sv = r_sv / torch.clamp(n_sv, min=1.0)
    b_all = r_all / torch.clamp(n_all, min=1.0)
    return torch.where(n_m > 0, b_margin, torch.where(n_sv > 0, b_sv, b_all))


def compute_rho_oneclass_batched(hss: HSSMatrix, alpha: torch.Tensor,
                                 hi_mat: torch.Tensor, masks: torch.Tensor,
                                 margin_rel: float = 1e-3) -> torch.Tensor:
    """One-class offset ρ = (K̃α)ᵢ averaged over the margin SVs
    (0 < αᵢ < 1/(νn)), all SVs when none is on the margin; the model bias
    is −ρ.  Blocks are (d, P); returns (P,)."""
    k_alpha = hss.matmat(alpha)
    tol = margin_rel * hi_mat
    on_margin = ((alpha > tol) & (alpha < hi_mat - tol) & (masks > 0)).to(alpha.dtype)
    sv = ((alpha > tol) & (masks > 0)).to(alpha.dtype)
    sums = torch.stack([on_margin.sum(0).float(), _colsum(on_margin, k_alpha),
                        sv.sum(0).float(), _colsum(sv, k_alpha)])
    n_m, k_m, n_sv, k_sv = dist_api.all_reduce_sum(sums, hss.mesh)
    rho_margin = k_m / torch.clamp(n_m, min=1.0)
    rho_sv = k_sv / torch.clamp(n_sv, min=1.0)
    return torch.where(n_m > 0, rho_margin, rho_sv)


def prolong_scale(task: str, n_coarse_real: int, n_fine_real: int) -> float:
    """Dual rescale n_c/n_f for coarse → fine prolongation: at a comparable
    margin the duals shrink like 1/n; for one-class it also restores eᵀα = 1."""
    del task
    return float(n_coarse_real) / float(max(n_fine_real, 1))


def svr_score(model, x_val, y_val) -> float:
    """Negated RMSE (higher is better; run_grid_search maximizes)."""
    pred = model.predict(x_val).float().cpu()
    y = torch.as_tensor(np.asarray(y_val), dtype=torch.float32)
    return -float(torch.sqrt(torch.mean((pred - y) ** 2)))


def oneclass_metrics(pred, y_true) -> dict:
    """Outlier-detection metrics from ±1 predictions against ±1 truth:
    precision and recall of the outlier (−1) class, balanced accuracy."""
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    y_true = np.asarray(y_true)
    flagged = pred < 0
    out = y_true < 0
    precision = float((flagged & out).sum() / max(flagged.sum(), 1))
    recall = float((flagged & out).sum() / max(out.sum(), 1))
    r_in = float((~flagged & ~out).sum() / max((~out).sum(), 1))
    return dict(precision=precision, recall=recall,
                balanced_accuracy=0.5 * (recall + r_in))


def oneclass_score(model, x_val, y_val) -> float:
    """Balanced accuracy of inlier (+1) / outlier (−1) detection."""
    return oneclass_metrics(model.predict(x_val), y_val)["balanced_accuracy"]


def grid_search_svr(x: np.ndarray, y: np.ndarray, x_val: np.ndarray,
                    y_val: np.ndarray, hs: Sequence[float],
                    epsilons: Sequence[float], c_value: float = 1.0,
                    trainer_kwargs: dict | None = None,
                    rtol: float | None = None) -> tuple[object, dict]:
    """(h, ε) grid for ε-SVR: per h one compression + one factorization for
    the warm-started ε sweep, scored by negated validation RMSE."""
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import resolve_rtol, run_grid_search

    kw = resolve_rtol(trainer_kwargs, rtol)
    return run_grid_search(
        lambda h: HSSSVMEngine(spec=KernelSpec(h=h), task="svr", svr_c=c_value, **kw),
        x, y, x_val, y_val, hs, epsilons, score_fn=svr_score)


def grid_search_oneclass(x: np.ndarray, x_val: np.ndarray, y_val: np.ndarray,
                         hs: Sequence[float], nus: Sequence[float],
                         trainer_kwargs: dict | None = None,
                         rtol: float | None = None) -> tuple[object, dict]:
    """(h, ν) grid for one-class SVM: unsupervised training, ``y_val`` ±1
    inlier/outlier labels scored by balanced accuracy."""
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import resolve_rtol, run_grid_search

    kw = resolve_rtol(trainer_kwargs, rtol)
    return run_grid_search(
        lambda h: HSSSVMEngine(spec=KernelSpec(h=h), task="oneclass", **kw),
        x, None, x_val, y_val, hs, nus, score_fn=oneclass_score)
