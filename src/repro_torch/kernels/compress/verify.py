"""Hold one level's row IDs against the plain version's (K2 on the card, or
any two f32 runs that sum in different orders).

The greedy pivots of two f32 runs can differ where two candidates' residual
norms tie to rounding; after such a step the two runs go on from different
skeletons.  ``compare_row_ids`` therefore asks, node by node:

* live slots only: slot < rank, where the rank is the adaptive build's
  prefix rank at ``rtol`` (the larger of the two runs'), or all k slots at
  fixed rank.  The build zeroes every slot past the rank, so its pivots,
  chosen by rounding once |R_ii| is at f32 noise, matter nowhere;
* at a node's first differing live step, is the difference a rounding tie?
  The block is assembled again in f64 and the shared earlier pivots are
  projected out.  After i deflation steps an f32 run knows a column's
  residual norm to about i·eps·|column|, so it may take either of two
  candidates whose true norms differ by less than the sum of their two
  error bars: the gap must stay within that sum.  Where the pivots agree
  but the ranks differ, the tie is with the threshold rtol·|R_00|, within
  the one column's error bar;
* past the divergence, is the run still a greedy pivoted QR?  Along the
  run's own pivots, in f64, each live pivot's residual norm must be the
  largest of the columns still available, within the same sum of error
  bars, and the run's rank must stop where its own |R_ii| falls below
  rtol·max|R_ii|, within the one column's error bar.  (The skeleton need
  not be as good as the plain one's: after a tie two greedy runs may end
  with residuals tens of percent apart.)
* on the nodes whose live pivots and rank agree, R on the live rows.

Each run also assembles its block in f32, and the Gaussian's norm
expansion |p|² + |c|² − 2p·c carries an error of a few eps·(|p|² + |c|²)
per entry.  Where a node's entries are all near 1 (dense low-dimensional
data, h above the node's width) that error, not the deflation's, is what
a column's norm is known to at the first steps: there even an f32 run of
the plain version departs from the f64 greedy pivots by more than the
deflation's error bars.  So the two questions are also asked with each
column's error bar widened by a bound on its assembly error
(``untied_asm``, ``off_greedy_asm``); the narrower answers stay as they
were.
"""
from __future__ import annotations

import torch

from repro_torch.core import idqr

F32_EPS = 2.0 ** -23


def live_counts(piv, r, piv_ref, r_ref, rtol: float | None):
    """(n_live, rank, rank_ref) per node: all k at fixed rank (rtol None)."""
    k = piv.shape[1]
    if rtol is None:
        full = torch.full((piv.shape[0],), k, dtype=torch.int32, device=piv.device)
        return full, full, full
    _, rank = idqr.finish_interp(piv, r, rtol, keep_identity=False)
    _, rank_ref = idqr.finish_interp(piv_ref, r_ref, rtol, keep_identity=False)
    return torch.maximum(rank, rank_ref), rank, rank_ref


def _block64(xc, xp, cm, h, kernel_name):
    """Aᵀ = K(xp, xc) · cmask of one node in f64, (s, m)."""
    c64, p64 = xc.double(), xp.double()
    if kernel_name == "laplacian":
        a_t = torch.exp(-torch.cdist(p64, c64, p=1) / h)
    else:
        a_t = torch.exp(-torch.cdist(p64, c64) ** 2 / (2 * h * h))
    return a_t * cm.double()[None, :]


def _assembly_err(xc, xp, cmask, h, kernel_name):
    """(m,) bound on each column of Aᵀ's error from one f32 assembly: the
    exponent's argument rounded f + 2 times (gaussian: |p|², |c|² and p·c
    sums of f terms, an add and a subtract, each within eps of |p|² + |c|²
    + 2|p||c|; laplacian: the f differences and the f-term sum, within eps
    of |p − c|₁ each), through exp's slope, plus exp's own rounding."""
    c64, p64 = xc.double(), xp.double()
    f = c64.shape[1]
    if kernel_name == "laplacian":
        d1 = torch.cdist(p64, c64, p=1)
        kk = torch.exp(-d1 / h)
        arg_err = 2 * f * F32_EPS * d1 / h
    else:
        np_, nc = (p64 * p64).sum(1), (c64 * c64).sum(1)
        kk = torch.exp(-torch.cdist(p64, c64) ** 2 / (2 * h * h))
        arg_err = (f + 2) * F32_EPS * (np_[:, None] + nc[None, :]
                                      + 2 * (np_[:, None] * nc[None, :]).sqrt()) / (2 * h * h)
    return (kk * (arg_err + F32_EPS) * cmask.double()[None, :]).norm(dim=0)


def _residual(a_t, cols):
    """A with the span of its columns ``cols`` projected out (f64)."""
    if len(cols) == 0:
        return a_t
    qmat, _ = torch.linalg.qr(a_t[:, cols])
    return a_t - qmat @ (qmat.T @ a_t)


def _greedy_gap(a_t, piv, n_live, rank, rtol, asm=None):
    """Worst departure of ``piv``'s first ``n_live`` steps from greedy
    pivoted QR on a_t (f64), in units of the rounding bound: at each step
    the chosen column's residual norm against the largest available one's,
    over the sum of their error bars i·eps·|column| (plus each column's
    assembly bound ``asm``, where given); with ``rtol``, also the rank
    against the run's own |R_ii| and rtol·max|R_ii|, over the pivot's error
    bar."""
    col = a_t.norm(dim=0)
    asm = torch.zeros_like(col) if asm is None else asm
    resid = a_t.clone()
    avail = torch.ones(a_t.shape[1], dtype=torch.bool, device=a_t.device)
    diag, worst = [], 0.0
    for i in range(n_live):
        n = resid.norm(dim=0)
        p = int(piv[i])
        best = int(torch.where(avail, n, -1.0).argmax())
        bar = max(i, 1) * F32_EPS
        worst = max(worst, (float(n[best]) - float(n[p]))
                    / (bar * float(col[p] + col[best]) + float(asm[p] + asm[best])))
        diag.append((float(n[p]), bar * float(col[p]) + float(asm[p])))
        q = resid[:, p] / max(float(n[p]), 1e-300)
        resid = resid - q[:, None] * (q @ resid)[None, :]
        avail[p] = False
    if rtol is not None and diag:
        tol = rtol * max(d for d, _ in diag)
        # Live steps stay above tol, the first dead one falls below it.
        for i, (d, bound) in enumerate(diag[:rank + 1]):
            worst = max(worst, ((tol - d) if i < rank else (d - tol)) / bound)
    return worst


def compare_row_ids(xc, xp, cmask, h, kernel_name, rtol, piv, r, piv_ref, r_ref) -> dict:
    """Compare (piv, R) with the plain version's (piv_ref, R_ref) on one level.

    Returns mismatches (nodes whose live pivots or ranks differ), untied
    (mismatches that are not rounding ties), worst_gap (in units of the
    rounding bound), off_greedy (mismatches whose own pivots leave greedy
    pivoted QR by more than rounding), worst_step_gap (the same unit),
    worst_ratio (the run's residual over the plain version's, with the same
    number of live skeletons; reported, not bounded), r_err (max
    |R - R_ref| on the live rows of the agreeing nodes), and untied_asm,
    worst_gap_asm, off_greedy_asm, worst_step_gap_asm: the same questions
    with each column's assembly error bound added to its error bar.
    """
    k = piv.shape[1]
    n_live, rank, rank_ref = live_counts(piv, r, piv_ref, r_ref, rtol)
    live = torch.arange(k, device=piv.device)[None, :] < n_live[:, None]
    differs = (piv != piv_ref) & live
    bad = differs.any(1) | (rank != rank_ref)
    out = dict(mismatches=int(bad.sum()), untied=0, worst_gap=0.0, off_greedy=0,
               worst_step_gap=0.0, worst_ratio=0.0, nodes=int(piv.shape[0]),
               untied_asm=0, worst_gap_asm=0.0, off_greedy_asm=0, worst_step_gap_asm=0.0)
    agree = live & ~bad[:, None]
    out["r_err"] = (float((r - r_ref).abs().amax(2)[agree].max()) if bool(agree.any())
                    else 0.0)
    for b in bad.nonzero().flatten().tolist():
        a_t = _block64(xc[b], xp[b], cmask[b], h, kernel_name)
        asm = _assembly_err(xc[b], xp[b], cmask[b], h, kernel_name)
        col = a_t.norm(dim=0)
        p_run, p_ref = piv[b].long(), piv_ref[b].long()
        if bool(differs[b].any()):
            i = int(differs[b].nonzero()[0])
            n = _residual(a_t, p_ref[:i]).norm(dim=0)
            j, j2 = int(p_ref[i]), int(p_run[i])
            diff = abs(float(n[j] - n[j2]))
            bar = max(i, 1) * F32_EPS * float(col[j] + col[j2])
            bar_asm = float(asm[j] + asm[j2])
        else:
            # Same live pivots, other rank: the step where one run stops is
            # a tie with the threshold rtol·|R_00|.
            i = int(torch.minimum(rank[b], rank_ref[b]))
            j = int(p_ref[i])
            n = _residual(a_t, p_ref[:i]).norm(dim=0)
            diff = abs(float(n[j]) - rtol * float(col[p_ref[0]]))
            bar = max(i, 1) * F32_EPS * float(col[j])
            bar_asm = float(asm[j])
        gap, gap_asm = diff / bar, diff / (bar + bar_asm)
        out["worst_gap"] = max(out["worst_gap"], gap)
        out["untied"] += gap > 1.0
        out["worst_gap_asm"] = max(out["worst_gap_asm"], gap_asm)
        out["untied_asm"] += gap_asm > 1.0
        nl = int(n_live[b])
        step_gap = _greedy_gap(a_t, p_run, nl, int(rank[b]), rtol)
        out["worst_step_gap"] = max(out["worst_step_gap"], step_gap)
        out["off_greedy"] += step_gap > 1.0
        step_gap = _greedy_gap(a_t, p_run, nl, int(rank[b]), rtol, asm)
        out["worst_step_gap_asm"] = max(out["worst_step_gap_asm"], step_gap)
        out["off_greedy_asm"] += step_gap > 1.0
        res_run = float(_residual(a_t, p_run[:nl]).norm())
        res_ref = float(_residual(a_t, p_ref[:nl]).norm())
        out["worst_ratio"] = max(out["worst_ratio"], res_run / max(res_ref, 1e-300))
    return out
