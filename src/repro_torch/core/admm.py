"""Closed-form ADMM for box-constrained kernel QPs (paper Algorithm 2).

Counterpart of ``repro.core.admm`` (fixed β).  Solves k problems

  min_x ½ xᵀ S K S x + pᵀx + γ‖x‖₁   s.t. aᵀx = b,  x ∈ [lo, hi]^d

that share ONE factorization of K̃ + βI (S a ±1 sign diagonal, so
S(K+βI)S = SKS + βI), split as x − z = 0.  Per iteration:

  x-step: x⁺ = S K_β⁻¹ S q − λ · S v,  q = −p + μ + β z,
          λ = (vᵀ(S q) − b) / ((S a)ᵀ v),  v = K_β⁻¹ (S a)  (one solve per
          call; without an equality constraint the λ term drops)
  z-step: z⁺ = Π_[lo,hi](soft(x⁺ − μ/β, γ/β))   (γ = 0: the box projection)
  μ-step: μ⁺ = μ − β (x⁺ − z⁺)

Instances: the SVM (S = Y, p = −e, a = y, b = 0, [0, C]; ``svm_task``),
ε-SVR and one-class (``repro_torch.core.tasks``).  The JAX ``lax.scan`` is
a Python loop here; the residual traces stay on the device and are stacked
once at the end.  ``tol`` freezes a problem once its relative residuals
pass (Boyd §3.3.1), ``ADMMTrace.iters_run`` counts its live iterations and
``done0`` seeds the freeze mask.  ``use_fused_update`` runs the z/μ step
through kernel K3 (γ = 0 and lo = 0 only: the SVM instance).
``admm_boxqp_adaptive`` balances the residuals by rescaling β between
chunks of iterations (``adaptive_rho_outer``, Boyd §3.4.1).

Under a mesh (``mesh``, ``repro_torch.dist.api``) every (d, k) block is the
rank's rows, the solver a node-split one, and each reduction over the
sample axis is a local partial plus one all-reduce: ``eq_dot`` once per
iteration, and the residual norms (and the stopping test's scales) as the
square roots of summed squares, all in one more.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.dist import api as dist_api
from repro_torch.kernels.admm_update import ops as admm_ops

SolverMat = Callable[[torch.Tensor], torch.Tensor]   # B (d, k) -> K_β⁻¹ B


@dataclasses.dataclass(frozen=True)
class BoxQPTask:
    """One batch of k box-QP problems sharing a single K_β factorization.

    All per-coordinate fields are (d, k) column blocks.  ``eq_sa`` is the
    equality vector pre-multiplied by the sign diagonal (S a): (d,) when the
    k problems share it, (d, k) for per-problem vectors, None for no
    equality constraint; ``eq_b`` (k,) its right-hand sides (None: 0);
    ``l1`` (k,) the ℓ1 weights γ (None: no prox).
    """

    sign: torch.Tensor            # (d, k) diagonal of S per problem (±1)
    lin: torch.Tensor             # (d, k) linear term p
    lo: torch.Tensor              # (d, k) box lower bounds
    hi: torch.Tensor              # (d, k) box upper bounds
    eq_sa: torch.Tensor | None = None
    eq_b: torch.Tensor | None = None
    l1: torch.Tensor | None = None


class ADMMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor


class ADMMTrace(NamedTuple):
    primal_res: torch.Tensor   # (max_it, k)  ||x - z|| per iteration
    dual_res: torch.Tensor     # (max_it, k)  beta * ||z - z_prev|| per iteration
    iters_run: torch.Tensor    # (k,) int32   iterations before the tol freeze
    done: torch.Tensor | None = None   # (k,) bool final freeze mask (tol runs)


@dataclasses.dataclass(frozen=True)
class ADMMParams:
    """Iteration control for engine-level ADMM runs.

    ``max_it``/``tol`` as in ``admm_boxqp``.  ``adapt_rho`` switches on
    residual-balancing ρ (Boyd §3.4.1, off by default): the run is cut into
    ``rho_every``-iteration chunks, and between chunks β is multiplied by
    ``rho_tau`` when the primal residual exceeds ``rho_mu`` times the dual
    one (divided in the other case).  β is also the factorization's shift,
    so each rescale implies a factorization of K̃ + βI (the engine caches
    one per visited β); ``rho_max_updates`` caps the rescales.

    ``rho_guard`` (the port's own, off by default: off is the reference's
    loop) stops the downward rescales at the engine's ``rho_floor()``, the
    β below which ADMM can diverge on an indefinite K̃.
    """

    max_it: int = 10
    tol: float | None = None
    adapt_rho: bool = False
    rho_every: int = 5
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    rho_max_updates: int = 4
    rho_guard: bool = False


def box_matrix(bound: torch.Tensor | float, d: int, k: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Normalize a box bound to (d, k) columns: accepts a scalar, a shared
    (d,) vector, or a per-problem (k, d) matrix (task row layout)."""
    arr = torch.as_tensor(bound, dtype=dtype, device=device)
    if arr.dim() == 1:
        arr = arr[:, None]
    elif arr.dim() == 2:
        arr = arr.T
    return arr.expand(d, k)


def svm_task(ys: torch.Tensor, c_upper: torch.Tensor | float) -> BoxQPTask:
    """The paper's binary SVM dual: S = Y and a = y per problem (so Sa = e,
    shared), p = −e, box [0, C].  ``ys`` is (k, d); ``c_upper`` a scalar, a
    shared (d,) vector or a per-problem (k, d) matrix."""
    k, d = ys.shape
    kw = dict(dtype=ys.dtype, device=ys.device)
    return BoxQPTask(
        sign=ys.T,
        lin=torch.full((d, k), -1.0, **kw),
        lo=torch.zeros((d, k), **kw),
        hi=box_matrix(c_upper, d, k, ys.dtype, ys.device),
        eq_sa=torch.ones((d,), **kw),
    )


def admm_boxqp(
    solver_mat: SolverMat,
    task: BoxQPTask,
    beta: float,
    max_it: int = 10,
    tol: float | None = None,
    z0: torch.Tensor | None = None,
    mu0: torch.Tensor | None = None,
    use_fused_update: bool = False,
    done0: torch.Tensor | None = None,
    mesh=None,
) -> tuple[ADMMState, ADMMTrace]:
    """Run k box-QP ADMM problems that share one (K̃ + βI) factorization.

    ``solver_mat`` applies (K̃ + βI)⁻¹ to a (d, k) block (one O(d r) sweep
    per iteration).  State is (d, k), traces (max_it, k).  ``z0``/``mu0``
    warm-start; ``done0`` (k,) seeds the freeze mask of a ``tol`` run.
    ``mesh``: the blocks are this rank's rows (module docstring).
    """
    d, k = task.sign.shape
    dtype, dev = task.sign.dtype, task.sign.device
    s_cols = task.sign
    neg_lin = -task.lin
    lo_mat = task.lo.expand(d, k)
    hi_mat = task.hi.expand(d, k)

    has_eq = task.eq_sa is not None
    if has_eq:
        if task.eq_sa.dim() == 1:                    # shared: ONE single-RHS solve
            v = solver_mat(task.eq_sa[:, None])[:, 0]
            w1 = dist_api.all_reduce_sum(task.eq_sa @ v, mesh)
            sv = s_cols * v[:, None]

            def eq_dot(sq):
                return dist_api.all_reduce_sum(v @ sq, mesh)
        else:                                        # per problem: one k-RHS solve
            v = solver_mat(task.eq_sa)
            w1 = dist_api.all_reduce_sum((task.eq_sa * v).sum(0), mesh)
            sv = s_cols * v

            def eq_dot(sq):
                return dist_api.all_reduce_sum((v * sq).sum(0), mesh)
        eq_b = (torch.zeros((k,), dtype=dtype, device=dev) if task.eq_b is None
                else task.eq_b)

    if use_fused_update:
        if task.l1 is not None:
            raise ValueError("fused z/mu update supports only gamma=0 tasks")
        if bool((task.lo != 0).any()):
            raise ValueError("fused z/mu update supports only lo=0 tasks")
        c_flat = hi_mat.reshape(-1).contiguous()

        def zmu_update(x, mu):
            z_f, mu_f = admm_ops.fused_zmu_update(
                x.reshape(-1), mu.reshape(-1), c_flat, beta)
            return z_f.reshape(x.shape), mu_f.reshape(x.shape)
    else:
        if task.l1 is None:
            def prox(t):
                return torch.minimum(torch.maximum(t, lo_mat), hi_mat)
        else:
            thr = (torch.as_tensor(task.l1, dtype=dtype, device=dev).expand(k)
                   / beta)[None, :]

            def prox(t):                # prox of (γ‖·‖₁ + box)/β: shrink, clip
                t = torch.sign(t) * torch.clamp(t.abs() - thr, min=0.0)
                return torch.minimum(torch.maximum(t, lo_mat), hi_mat)

        def zmu_update(x, mu):
            z_new = prox(x - mu / beta)
            return z_new, mu - beta * (x - z_new)

    x = torch.zeros((d, k), dtype=dtype, device=dev)
    z = torch.zeros((d, k), dtype=dtype, device=dev) if z0 is None else z0
    mu = torch.zeros((d, k), dtype=dtype, device=dev) if mu0 is None else mu0
    if tol is not None:
        done = (torch.zeros((k,), dtype=torch.bool, device=dev) if done0 is None
                else done0.to(torch.bool))
        iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    primals, duals = [], []
    for _ in range(max_it):
        sq = s_cols * (neg_lin + mu + beta * z)
        u = solver_mat(sq)                          # ONE k-RHS solve
        if has_eq:
            lam = (eq_dot(sq) - eq_b) / w1          # (k,)
            x_new = s_cols * u - lam[None, :] * sv
        else:
            x_new = s_cols * u
        z_new, mu_new = zmu_update(x_new, mu)
        if tol is not None:
            keep = done[None, :]                    # frozen problems hold
            x_new = torch.where(keep, x, x_new)
            z_new = torch.where(keep, z, z_new)
            mu_new = torch.where(keep, mu, mu_new)
            iters = iters + (~done).to(torch.int32)
        cols = [x_new - z_new, z_new - z] + ([x_new, z_new, mu_new] if tol is not None
                                             else [])
        norms = _col_norms(cols, mesh)
        primal, dual = norms[0], beta * norms[1]
        if tol is not None:
            # Relative stopping test (Boyd §3.3.1).
            p_scale = 1.0 + torch.maximum(norms[2], norms[3])
            d_scale = 1.0 + norms[4]
            done = done | ((primal < tol * p_scale) & (dual < tol * d_scale))
        x, z, mu = x_new, z_new, mu_new
        primals.append(primal)
        duals.append(dual)
    if tol is None:
        iters = torch.full((k,), max_it, dtype=torch.int32, device=dev)
        done = None
    trace = ADMMTrace(torch.stack(primals), torch.stack(duals), iters, done)
    return ADMMState(x, z, mu), trace


def _col_norms(blocks: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Column 2-norms of each (d, k) block; under a mesh the square root of
    the ranks' summed squares, all blocks in one all-reduce."""
    if mesh is None:
        return [torch.linalg.vector_norm(b, dim=0) for b in blocks]
    sq = dist_api.all_reduce_sum(torch.stack([(b * b).sum(0) for b in blocks]), mesh)
    return list(torch.sqrt(sq))


def adaptive_rho_outer(
    run_chunk: Callable,
    beta0: float,
    params: ADMMParams,
    z0: torch.Tensor | None = None,
    mu0: torch.Tensor | None = None,
    beta_min: float = 0.0,
) -> tuple[ADMMState, ADMMTrace, dict]:
    """Residual-balancing ρ (Boyd §3.4.1) as a host loop over chunks.

    ``run_chunk(beta, n_it, z0, mu0, done0) -> (ADMMState, ADMMTrace)`` runs
    ``n_it`` iterations at penalty β; the caller owns the factorization of
    K̃ + βI that a rescale implies.  Between chunks the last live residuals
    are balanced: primal > ρ_μ·dual ⟹ β ← τβ, dual > ρ_μ·primal ⟹ β ← β/τ,
    at most ``rho_max_updates`` times.  The UNSCALED multiplier μ is carried
    across a rescale (it is the β-invariant quantity: Boyd eq. 3.14 rescales
    the scaled u = μ/β), and the freeze mask is reset, since the relative
    stopping test moves with β.

    ``beta_min`` floors the downward rescales; a rescale that would take β
    below it does not happen.  0, the default, is the reference's loop.
    (The engine passes its ``rho_floor()`` under ``ADMMParams.rho_guard``.)

    Returns (state, trace, info): ``trace.iters_run`` sums the LIVE
    iterations of all chunks, the residual traces are the chunks' joined,
    and ``info`` holds the final β and the rescale count.
    """
    z, mu, done = z0, mu0, None
    beta = float(beta0)
    it_left = int(params.max_it)
    rescales = 0
    iters_total = None
    state = None
    prs: list[torch.Tensor] = []
    drs: list[torch.Tensor] = []
    while it_left > 0:
        n_it = min(params.rho_every, it_left) if params.adapt_rho else it_left
        state, trace = run_chunk(beta, n_it, z, mu, done)
        z, mu, done = state.z, state.mu, trace.done
        iters_total = (trace.iters_run if iters_total is None
                       else iters_total + trace.iters_run)
        prs.append(trace.primal_res)
        drs.append(trace.dual_res)
        it_left -= n_it
        if done is not None and bool(done.all()):
            break
        if params.adapt_rho and it_left > 0 and rescales < params.rho_max_updates:
            pr, dr = trace.primal_res[-1], trace.dual_res[-1]
            if done is not None:      # balance on LIVE problems only
                pr = torch.where(done, 0.0, pr)
                dr = torch.where(done, 0.0, dr)
            p, d = float(pr.max()), float(dr.max())
            new_beta = beta
            if p > params.rho_mu * d:
                new_beta = beta * params.rho_tau
            elif d > params.rho_mu * p and beta / params.rho_tau >= beta_min:
                new_beta = beta / params.rho_tau
            if new_beta != beta:
                beta = new_beta
                rescales += 1
                done = None
    trace = ADMMTrace(torch.cat(prs), torch.cat(drs), iters_total, done)
    return state, trace, dict(beta=beta, rescales=rescales)


def admm_boxqp_adaptive(
    solver_for: Callable[[float], SolverMat],
    task: BoxQPTask,
    beta0: float,
    params: ADMMParams,
    z0: torch.Tensor | None = None,
    mu0: torch.Tensor | None = None,
    beta_min: float = 0.0,
    mesh=None,
) -> tuple[ADMMState, ADMMTrace, dict]:
    """``admm_boxqp`` under the residual-balancing outer loop.

    ``solver_for(beta)`` returns a (d, k)-block solver of (K̃ + βI), cached
    per visited β by the caller (the engine's ``_fac_for``).  With
    ``params.adapt_rho`` False this is one plain ``admm_boxqp`` run (plus
    the info dict).  ``beta_min``: as in ``adaptive_rho_outer``; ``mesh``:
    as in ``admm_boxqp`` (the residuals it balances are already global).
    """
    def run_chunk(beta, n_it, z, mu, done):
        return admm_boxqp(solver_for(beta), task, beta, max_it=n_it, tol=params.tol,
                          z0=z, mu0=mu, done0=done, mesh=mesh)

    return adaptive_rho_outer(run_chunk, beta0, params, z0=z0, mu0=mu0, beta_min=beta_min)


def admm_svm(
    solver: Callable[[torch.Tensor], torch.Tensor],
    y: torch.Tensor,
    c_upper: torch.Tensor | float,
    beta: float,
    max_it: int = 10,
    z0: torch.Tensor | None = None,
    mu0: torch.Tensor | None = None,
    use_fused_update: bool = False,
    tol: float | None = None,
    mesh=None,
) -> tuple[ADMMState, ADMMTrace]:
    """Single-problem (k = 1) view of ``admm_svm_batched``; ``solver``
    applies (K̃ + βI)⁻¹ to a (d,) vector."""
    d = y.shape[0]
    c_vec = torch.as_tensor(c_upper, dtype=y.dtype, device=y.device).expand(d)
    state, trace = admm_svm_batched(
        lambda b: solver(b[:, 0])[:, None],
        y[None, :], c_vec[None, :], beta, max_it,
        z0=None if z0 is None else z0[:, None],
        mu0=None if mu0 is None else mu0[:, None],
        use_fused_update=use_fused_update,
        tol=tol,
        mesh=mesh,
    )
    return (ADMMState(*(a[:, 0] for a in state)),
            ADMMTrace(trace.primal_res[:, 0], trace.dual_res[:, 0],
                      trace.iters_run[0],
                      None if trace.done is None else trace.done[0]))


def admm_svm_batched(
    solver_mat: SolverMat,
    ys: torch.Tensor,
    c_upper: torch.Tensor | float,
    beta: float,
    max_it: int = 10,
    z0: torch.Tensor | None = None,
    mu0: torch.Tensor | None = None,
    use_fused_update: bool = False,
    tol: float | None = None,
    mesh=None,
) -> tuple[ADMMState, ADMMTrace]:
    """Run k SVM dual ADMM problems that share one (K̃ + βI) factorization;
    ``ys`` is (k, d), one ±1 label vector per problem."""
    return admm_boxqp(solver_mat, svm_task(ys, c_upper), beta, max_it=max_it,
                      tol=tol, z0=z0, mu0=mu0,
                      use_fused_update=use_fused_update, mesh=mesh)


def paper_beta(d: int) -> float:
    """The paper's β staging rule (§3.3): 1e2 / 1e3 / 1e4 by training size."""
    if d >= 1_000_000:
        return 1e4
    if d >= 100_000:
        return 1e3
    return 1e2
