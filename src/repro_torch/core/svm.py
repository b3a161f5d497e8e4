"""SVM bias extraction and the fit report (counterpart of ``repro.core.svm``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hss import HSSMatrix


@dataclasses.dataclass
class FitReport:
    """Timings mirroring the paper's Tables 4/5 columns, plus the exact
    number of kernel entries the compression evaluated and the per-problem
    ADMM iterations of the last ``train``."""

    compression_s: float
    factorization_s: float
    admm_s: float
    memory_mb: float
    hss_levels: int
    beta: float
    ranks_pre: tuple | None = None
    ranks_post: tuple | None = None
    rank_sum_pre: int | None = None
    rank_sum_post: int | None = None
    kernel_evals: int | None = None
    iters_run: tuple | None = None


def compute_bias_batched(hss: HSSMatrix, ys: torch.Tensor, z: torch.Tensor,
                         c_mat: torch.Tensor, masks: torch.Tensor,
                         margin_tol: float = 1e-6) -> torch.Tensor:
    """Paper eq. (7) for P problems sharing one kernel, with ONE HSS matmat.

    b_p = (z_yᵀ K̃ ē − Σ_{j∈M_p} y_j) / |M_p| where M_p = margin support
    vectors {j : 0 < z_jp < C_jp} of problem p; the average functional
    margin over all bounded SVs when M_p is empty.  ``ys``/``z``/``c_mat``/
    ``masks`` are (d, P) column blocks; returns (P,).
    """
    on_margin = ((z > margin_tol) & (z < c_mat - margin_tol)
                 & (masks > 0)).to(z.dtype)
    n_m = on_margin.sum(0)                                 # (P,)
    kz = hss.matmat(ys * z)                 # K̃ (Y z) — one O(N r) sweep
    num = (on_margin * kz).sum(0) - (on_margin * ys).sum(0)
    b_margin = -num / torch.clamp(n_m, min=1.0)
    sv = ((z > margin_tol) & (masks > 0)).to(z.dtype)
    n_sv = torch.clamp(sv.sum(0), min=1.0)
    b_all = -((sv * kz).sum(0) - (sv * ys).sum(0)) / n_sv
    return torch.where(n_m > 0, b_margin, b_all)


def compute_bias(hss: HSSMatrix, y: torch.Tensor, z: torch.Tensor, c_value: float,
                 mask: torch.Tensor, margin_tol: float = 1e-6) -> torch.Tensor:
    """Paper eq. (7) for a single binary problem (P = 1 view)."""
    c_mat = torch.full((z.shape[0], 1), c_value, dtype=z.dtype, device=z.device)
    return compute_bias_batched(
        hss, y[:, None], z[:, None], c_mat, mask[:, None], margin_tol)[0]
