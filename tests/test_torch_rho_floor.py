"""Adaptive ρ's β floor (the port's opt-in guard), held against the JAX package.

A crude compression of a positive-definite kernel can leave K̃ indefinite
(8192 blobs points at the crude preset: least eigenvalue about −1.9 against
a largest of about 85).  The SVM's x-step then minimizes a nonconvex
quadratic.  ADMM on a direction of negative curvature −|λ| that the box
blocks multiplies its error by −|λ|/(β − |λ|) a step, so it needs β > 2|λ|
(``HSSSVMEngine.rho_floor``): at 1.05·|λ_min| it diverges to NaN, in the
JAX package as in the port; at 1.5·|λ_min| it stalls; at the floor it
converges.  Under ``ADMMParams(rho_guard=True)`` residual balancing stops
at the floor; without it the port's engine runs the reference's loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as jadmm
from repro.core import compression as jcomp
from repro.core import factorization as jfact
from repro.core import tree as jtree
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch.core import admm as tadmm
from repro_torch.core import lanczos
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")
N, LEAF = 8192, 128


@pytest.fixture(scope="module")
def engines():
    xtr, ytr, xte, yte = synthetic.train_test("blobs", N, 512, seed=0, n_features=8, sep=1.6)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams.crude(), leaf_size=LEAF, beta=1e4,
                 admm=tadmm.ADMMParams(max_it=200, tol=3e-2), device="cpu")
    te.prepare(xtr, ytr)
    # the reference's K̃ of the same padded, permuted points
    x_pad, y_pad, mask, levels = jtree.pad_dataset(xtr, ytr.astype(np.float32), LEAF)
    t = jtree.build_tree(x_pad, LEAF, levels)
    jhss = jcomp.compress(x_pad[t.perm], t, JSpec(h=1.0), jcomp.CompressionParams.crude())
    y = np.where(y_pad[t.perm] > 0, 1.0, -1.0).astype(np.float32)[None]
    return te, (jhss, y, mask[t.perm].astype(np.float32)[None]), xte, yte


def test_floor_is_twice_the_least_eigenvalue(engines):
    te, _, _, _ = engines
    theta, resid = lanczos.lowest_eigenvalue(te.hss)
    assert theta < 0.0                                   # K̃ is indefinite here
    assert resid < 1e-3 * -theta                         # the Ritz pair has converged
    assert te.rho_floor() == 2.0 * (resid - theta)
    # a Ritz value never lies below the true least eigenvalue: its vector's
    # Rayleigh quotient reads negative too
    alphas, betas, basis = lanczos.lanczos(te.hss.matvec, lanczos.start_vector(te.hss.n, "cpu"),
                                           120)
    evals, evecs = lanczos.tridiag_eigh(alphas, betas[:-1])
    v = basis[:120].T @ evecs[:, 0]
    assert float(v @ te.hss.matvec(v) / (v @ v)) < 0.0


def test_admm_diverges_just_above_the_negative_curvature_in_both_packages(engines):
    """At β = 1.05·|λ_min| the reference's ADMM and the port's both end in
    NaN; at the floor, 2·|λ_min|, the port's converges."""
    te, (jhss, y, mask), _, _ = engines
    floor = te.rho_floor()
    beta = 0.525 * floor
    jtask = jadmm.svm_task(jnp.asarray(y), 1.0 * jnp.asarray(mask))
    jst, _ = jadmm.admm_boxqp(jfact.factorize(jhss, beta).solve_mat, jtask, beta, max_it=200)
    assert not np.isfinite(np.asarray(jst.z)).all()
    task = tadmm.svm_task(te.problem_labels, 1.0 * te.problem_masks)
    st, _ = tadmm.admm_boxqp(te._fac_for(beta).solve_mat, task, beta, max_it=200)
    assert not bool(torch.isfinite(st.z).all())
    st, tr = tadmm.admm_boxqp(te._fac_for(floor).solve_mat, task, floor, max_it=200)
    assert bool(torch.isfinite(st.z).all()) and float(tr.primal_res[-1, 0]) < 1e-2


def test_admm_stalls_below_twice_the_negative_curvature(engines):
    """At β = 1.5·|λ_min|, inside (|λ|, 2|λ|), fixed-β ADMM stays finite but
    does not converge in 400 iterations; at the floor it does."""
    te, _, _, _ = engines
    floor = te.rho_floor()
    task = tadmm.svm_task(te.problem_labels, 1.0 * te.problem_masks)
    res = {}
    for beta in (0.75 * floor, floor):
        st, tr = tadmm.admm_boxqp(te._fac_for(beta).solve_mat, task, beta, max_it=400)
        assert bool(torch.isfinite(st.z).all())
        res[beta] = float(tr.primal_res[-1, 0])
    assert res[0.75 * floor] > 1.0 and res[floor] < 1e-3


def test_adaptive_rho_never_rescales_below_the_floor(engines):
    """Residual balancing under the guard, with room for 16 halvings of β:
    the visited β stop at the floor, and the model is finite and above the
    blobs paths' accuracy floor (0.93, chip_smoke.py)."""
    te, _, xte, yte = engines
    te.admm = tadmm.ADMMParams(max_it=200, tol=3e-2, adapt_rho=True, rho_every=5,
                               rho_max_updates=16, rho_guard=True)
    visited = []
    fac_for = te._fac_for
    te._fac_for = lambda b: visited.append(b) or fac_for(b)
    model, _ = te.train(1.0)
    del te._fac_for
    floor = te.rho_floor()
    assert min(visited) >= floor and te.report.rho_final >= floor
    assert min(visited) / 2.0 < floor        # the floor, not the cap, stopped it
    assert bool(torch.isfinite(model.z_y).all())
    assert float((model.predict(xte).numpy() == yte).mean()) >= 0.93


def test_adaptive_rho_without_the_guard_is_the_reference_loop(engines):
    """By default the port's engine runs the reference's loop on the same
    indefinite K̃: the JAX package's β sequence, final β and rescale count,
    below the port's floor."""
    te, (jhss, y, mask), _, _ = engines
    params = dict(max_it=200, tol=3e-2, adapt_rho=True, rho_every=5, rho_max_updates=16)
    te.admm = tadmm.ADMMParams(**params)
    visited = []
    fac_for = te._fac_for
    te._fac_for = lambda b: visited.append(b) or fac_for(b)
    te.train(1.0)
    del te._fac_for
    jvisited, jfacs = [], {}

    def j_for(b):
        jvisited.append(b)
        if b not in jfacs:
            jfacs[b] = jfact.factorize(jhss, b).solve_mat
        return jfacs[b]

    jtask = jadmm.svm_task(jnp.asarray(y), 1.0 * jnp.asarray(mask))
    _, _, jinfo = jadmm.admm_boxqp_adaptive(j_for, jtask, 1e4, jadmm.ADMMParams(**params))
    assert visited == jvisited
    assert (te.report.rho_final, te.report.rho_rescales) == (jinfo["beta"], jinfo["rescales"])
    assert te.report.rho_final < te.rho_floor()
