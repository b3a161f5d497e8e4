"""The multilevel warm start and adaptive ρ of the port, against the JAX package.

``prolong_duals`` copies the same neighbours' values exactly; the port's
``adaptive_rho_outer`` on the JAX package's factorizations (carried across
with ``repro_torch.convert``, one per visited β) takes the same β sequence,
rescales and live iterations, with residual traces at 1e-4 of their largest
value; ``admm_boxqp_adaptive`` without adaptation is plain ``admm_boxqp``;
the rescale cap holds; and the engines' ``train_multilevel`` and adaptive
``train`` agree on a 1024-point copy of the repo's svm_multilevel /
svm_adaptive_rho bench cases (benchmarks/bench_svm.py): accuracy equal,
iterations within 2, duals within 1e-4 of C.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as jadmm
from repro.core import compression as jcomp
from repro.core import factorization as jfact
from repro.core import svm as jsvm
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import admm as tadmm
from repro_torch.core import svm as tsvm
from repro_torch.core import tree as tree_mod
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("cols", [None, 3])
def test_prolong_duals_matches_jax_exactly(cols):
    r = np.random.default_rng(0)
    xc = r.normal(size=(300, 5)).astype(np.float32)
    xf = r.normal(size=(2000, 5)).astype(np.float32)
    z = r.normal(size=(300,) if cols is None else (300, cols)).astype(np.float32)
    got = tsvm.prolong_duals(xc, z, xf)
    want = jsvm.prolong_duals(xc, z, xf)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# adaptive ρ on the JAX factorizations                                   #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def problem():
    xtr, ytr, _, _ = synthetic.train_test("blobs", 512, 0, seed=0, n_features=5, sep=3.0)
    x_pad, y_pad, mask, levels = tree_mod.pad_dataset(xtr, ytr.astype(np.float32), 64)
    t = tree_mod.build_tree(x_pad, 64, levels)
    xp = x_pad[t.perm]
    jhss = jcomp.compress(xp, t, JSpec(h=2.0), jcomp.CompressionParams.crude())
    y = np.where(y_pad[t.perm] > 0, 1.0, -1.0).astype(np.float32)
    return jhss, y, mask[t.perm].astype(np.float32)


def _port_fac(jf):
    return convert.factorization_from_numpy(
        e_leaf=np.asarray(jf.e_leaf), g_leaf=np.asarray(jf.g_leaf),
        e_lvls=[np.asarray(a) for a in jf.e_lvls], g_lvls=[np.asarray(a) for a in jf.g_lvls],
        root_lu=np.asarray(jf.root_lu), root_piv=np.asarray(jf.root_piv),
        levels=jf.levels, leaf_size=jf.leaf_size, beta=jf.beta, device="cpu")


def _run_both(problem, params, beta0=1e4):
    jhss, y, mask = problem
    jfacs, seen = {}, {"jax": [], "port": []}

    def jfac(b):
        if b not in jfacs:
            jfacs[b] = jfact.factorize(jhss, b)
        return jfacs[b]

    def j_for(b):
        seen["jax"].append(b)
        return jfac(b).solve_mat

    tfacs = {}

    def t_for(b):
        seen["port"].append(b)
        if b not in tfacs:
            tfacs[b] = _port_fac(jfac(b))
        return tfacs[b].solve_mat

    jtask = jadmm.svm_task(jnp.asarray(y)[None], 1.0 * jnp.asarray(mask))
    ttask = tadmm.svm_task(torch.as_tensor(y)[None], 1.0 * torch.as_tensor(mask))
    # the reference's knobs (the port adds ``rho_guard``)
    jp = jadmm.ADMMParams(**{f: getattr(params, f)
                             for f in jadmm.ADMMParams.__dataclass_fields__})
    jst, jtr, jinfo = jadmm.admm_boxqp_adaptive(j_for, jtask, beta0, jp)
    tst, ttr, tinfo = tadmm.admm_boxqp_adaptive(t_for, ttask, beta0, params)
    return (jst, jtr, jinfo), (tst, ttr, tinfo), seen


@pytest.mark.parametrize("tol", [3e-2, None])
def test_adaptive_rho_outer_on_jax_factorizations(problem, tol):
    params = tadmm.ADMMParams(max_it=60, tol=tol, adapt_rho=True, rho_every=5,
                              rho_max_updates=8)
    (jst, jtr, jinfo), (tst, ttr, tinfo), seen = _run_both(problem, params)
    assert seen["port"] == seen["jax"]                 # the same β per chunk
    assert tinfo == jinfo and tinfo["rescales"] > 0
    assert ttr.iters_run.tolist() == np.asarray(jtr.iters_run).tolist()
    for port, ref in ((ttr.primal_res, jtr.primal_res), (ttr.dual_res, jtr.dual_res)):
        ref = np.asarray(ref)
        assert port.shape == ref.shape
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(tst.z.numpy(), np.asarray(jst.z), rtol=0, atol=1e-4)


def test_rescale_cap_respected(problem):
    params = tadmm.ADMMParams(max_it=30, tol=None, adapt_rho=True, rho_every=5,
                              rho_max_updates=2)
    _, (_, _, tinfo), seen = _run_both(problem, params)
    assert tinfo["rescales"] == 2 and len(set(seen["port"])) == 3
    assert len(seen["port"]) == 6                      # 30 / 5 chunks


def test_boxqp_adaptive_without_adaptation_is_plain_admm(problem):
    jhss, y, mask = problem
    fac = _port_fac(jfact.factorize(jhss, 100.0))
    task = tadmm.svm_task(torch.as_tensor(y)[None], 1.0 * torch.as_tensor(mask))
    for tol in (None, 3e-2):
        params = tadmm.ADMMParams(max_it=40, tol=tol)
        st, tr, info = tadmm.admm_boxqp_adaptive(lambda b: fac.solve_mat, task, 100.0, params)
        st0, tr0 = tadmm.admm_boxqp(fac.solve_mat, task, 100.0, max_it=40, tol=tol)
        assert info == dict(beta=100.0, rescales=0)
        for a, b in zip((*st, tr.primal_res, tr.dual_res, tr.iters_run),
                        (*st0, tr0.primal_res, tr0.dual_res, tr0.iters_run)):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the engines: bench cases at 1024 points                                #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def data():
    return synthetic.train_test("blobs", 1024, 256, seed=0, n_features=5, sep=3.0)


def _engines(beta, admm_kw):
    je = JEngine(spec=JSpec(h=2.0), comp=jcomp.CompressionParams.crude(), leaf_size=128,
                 beta=beta, admm=jadmm.ADMMParams(**admm_kw))
    te = TEngine(spec=TSpec(h=2.0), comp=TParams.crude(), leaf_size=128, beta=beta,
                 admm=tadmm.ADMMParams(**admm_kw), device="cpu")
    return je, te


def _agree(jm, tm, xte, yte):
    """Accuracy equal; the duals y·z within 1e-4 of C = 1."""
    acc_j = float(np.mean(np.asarray(jm.predict(jnp.asarray(xte))) == yte))
    acc_t = float(np.mean(tm.predict(xte).numpy() == yte))
    assert acc_t == acc_j
    np.testing.assert_allclose(tm.z_y.numpy(), np.asarray(jm.z_y), rtol=0, atol=1e-4 * 1.0)


def test_engine_train_multilevel_matches_jax(data):
    xtr, ytr, xte, yte = data
    je, te = _engines(100.0, dict(max_it=400, tol=3e-2))
    je.prepare(xtr, ytr)
    te.prepare(xtr, ytr)
    jm, jinfo = je.train_multilevel(1.0, coarse_frac=0.25, coarse_leaf_size=64, seed=0)
    tm, tinfo = te.train_multilevel(1.0, coarse_frac=0.25, coarse_leaf_size=64, seed=0)
    assert tinfo["coarse_n"] == jinfo["coarse_n"]
    for key in ("iters_run", "coarse_iters_run"):
        assert abs(tinfo[key][0] - jinfo[key][0]) <= 2, (key, tinfo[key], jinfo[key])
    _agree(jm, tm, xte, yte)


def test_engine_adaptive_rho_matches_jax(data):
    xtr, ytr, xte, yte = data
    je, te = _engines(1e4, dict(max_it=400, tol=3e-2, adapt_rho=True, rho_every=5,
                                rho_max_updates=8))
    je.prepare(xtr, ytr)
    te.prepare(xtr, ytr)
    jm, _ = je.train(1.0)
    tm, _ = te.train(1.0)
    rj, rt = je.report, te.report
    assert (rt.rho_final, rt.rho_rescales) == (rj.rho_final, rj.rho_rescales)
    assert rt.rho_rescales > 0
    assert abs(rt.iters_run[0] - rj.iters_run[0]) <= 2
    # one factorization per visited β: prepare's, then one per rescale
    assert len(te._fac_cache) == rt.rho_rescales + 1
    assert te._fac_cache.keys() == je._fac_cache.keys()
    _agree(jm, tm, xte, yte)
