"""Distributed HSS-ADMM SVM training: the warm-started C-grid functions.

Counterpart of ``repro.core.distributed``'s C-grid functions.  The sample
dimension d is split over every rank of the mesh (``repro_torch.dist.api``):
the leaf-level factors and the rows of every ADMM vector live on the rank
that owns them, the upper levels of the factorization are replicated, and
the only traffic between ranks is

  * one gather of the projected right-hand side at the cut of every solve
    (O(r n_k)), and
  * the scalar reductions of each iteration (eᵀw, the residual norms):
    one all-reduce each,

the communication pattern of distributed-memory HSS solvers (STRUMPACK).
A whole factorization passed in is first cut to the rank's nodes
(``factorization.shard``, the port's counterpart of placing it with
``fac_shardings``); a node-split one (``factorize_sharded``) is used as it is.
The labels and per-coordinate C vectors are of full length, as the
reference's single controller holds them; each rank takes its rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.admm import admm_svm, admm_svm_batched
from repro_torch.core.factorization import HSSFactorization, shard
from repro_torch.dist import api as dist_api


def admm_train_distributed(fac: HSSFactorization, y, c_values, mesh, max_it: int = 10,
                           warm_start: bool = True) -> list:
    """The ADMM C-grid over ``mesh`` (paper Alg. 3 lines 7-14).

    ``y`` (n,) ±1 labels; ``c_values`` entries are scalars or (n,)
    per-coordinate bounds (0 pins a pad).  Consecutive C values warm-start
    from the previous (z, μ), as ``svm.grid_search`` does on one device.
    Returns one (z, primal_res trace) per C, z as this rank's rows.
    """
    def run(fac_, y_, c, z0, mu0):
        state, trace = admm_svm(fac_.solve, y_, c, fac_.beta, max_it, z0=z0, mu0=mu0,
                                mesh=mesh)
        return state.z, state.mu, trace.primal_res

    def make_c(c):
        c = torch.as_tensor(c, dtype=torch.float32, device=y_r.device)
        return dist_api.local_rows(c, mesh) if c.dim() == 1 else c

    y_r = dist_api.local_rows(torch.as_tensor(y, dtype=torch.float32), mesh)
    y_r = y_r.to(fac.e_leaf.device)
    return _run_c_grid(fac, y_r, c_values, mesh, run, make_c, torch.zeros_like(y_r),
                       warm_start)


def admm_train_multiclass_distributed(fac: HSSFactorization, ys, c_values, mesh,
                                      max_it: int = 10, warm_start: bool = True,
                                      pmask=None) -> list:
    """The batched multiclass ADMM C-grid over ``mesh``.

    ``ys`` (P, n) per-class (or per-pair) labels; the iterate blocks are
    (n, P) with the sample axis split over the ranks and the class axis
    whole on each, so the P-fold right-hand side adds no traffic beyond P
    columns in the same collectives.  ``pmask`` (P, n) pins
    non-participating coordinates to [0, 0] (one-vs-one pairs).  Returns
    one (z (n_rank, P), primal_res (max_it, P)) per C.
    """
    def rows(a):
        return dist_api.local_rows(torch.as_tensor(a, dtype=torch.float32).T, mesh
                                   ).T.to(fac.e_leaf.device)

    ys_r = rows(ys)
    mask_r = torch.ones_like(ys_r) if pmask is None else rows(pmask)

    def run(fac_, ys_, c_upper, z0, mu0):
        state, trace = admm_svm_batched(fac_.solve_mat, ys_, c_upper, fac_.beta, max_it,
                                        z0=z0, mu0=mu0, mesh=mesh)
        return state.z, state.mu, trace.primal_res

    def make_c(c):
        return torch.as_tensor(c, dtype=torch.float32) * mask_r

    zeros = torch.zeros(ys_r.T.shape, dtype=torch.float32, device=ys_r.device)
    return _run_c_grid(fac, ys_r, c_values, mesh, run, make_c, zeros, warm_start)


def _run_c_grid(fac, labels, c_values, mesh, run, make_c, zeros, warm_start) -> list:
    """Shared warm-started C-grid loop of the vector and (n, P) block
    paths: cut the factorization to the rank's nodes once (unless it is
    already node-split), then sweep C reusing it."""
    fac_r = fac if fac.mesh is not None else shard(fac, mesh)
    z0, mu0 = zeros, zeros
    out = []
    for c in c_values:
        z, mu, res = run(fac_r, labels, make_c(c), z0, mu0)
        out.append((z, res))
        if warm_start:
            z0, mu0 = z, mu
    return out
