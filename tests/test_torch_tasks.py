"""The port's box-QP task layer (ε-SVR, ν one-class) against the JAX package.

The same numpy data go through the JAX engine (XLA kernel blocks) and the
port's engine (plain versions on CPU tensors); the generalized
``admm_boxqp`` (ℓ1 prox, ``eq_b``, per-problem ``eq_sa``, ``done0``) is held
per iteration on the JAX factorization carried across with
``repro_torch.convert``; the biases on the same duals; the golden SVR and
one-class pins of tests/test_golden.py on the port; and the KKT residuals
of tests/proptest.py on the port's iterates.

Tolerances: the two builds pick the same skeletons and their HSS arrays
agree to ~1e-5; the golden runs take 30 iterations (three times the binary
golden run's, whose duals agree to 1e-5 of C), and SVR's β is 10 (a tenth
of the binary run's), so duals are held to 1e-4 of their box (measured:
1.4e-5 SVR, 9.4e-5 one-class); residual traces to 1e-4 of their largest
value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as jadmm
from repro.core import tasks as jtasks
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import admm as tadmm
from repro_torch.core import tasks as ttasks
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec, gaussian_block
from tests import proptest as pt
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

# tests/test_golden.py's configuration.
COMP = dict(rank=32, n_near=48, n_far=64)


def _fac_to_port(jfac):
    return convert.factorization_from_numpy(
        e_leaf=np.asarray(jfac.e_leaf), g_leaf=np.asarray(jfac.g_leaf),
        e_lvls=[np.asarray(a) for a in jfac.e_lvls],
        g_lvls=[np.asarray(a) for a in jfac.g_lvls],
        root_lu=np.asarray(jfac.root_lu), root_piv=np.asarray(jfac.root_piv),
        levels=jfac.levels, leaf_size=jfac.leaf_size, beta=jfac.beta, device="cpu")


@pytest.fixture(scope="module")
def svr():
    """tests/test_golden.py::test_golden_svr_rmse_noisy_sine on both."""
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", 1024, 256, seed=0, noise=0.1)
    kw = dict(leaf_size=128, task="svr", svr_c=2.0, beta=10.0)
    je = JEngine(spec=JSpec(h=1.0), comp=JParams(**COMP), max_it=30, **kw)
    je.prepare(xtr, ytr)
    jm, (jz, _) = je.train(0.1)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams(**COMP), admm=tadmm.ADMMParams(max_it=30),
                 device="cpu", **kw)
    te.prepare(xtr, ytr)
    tm, (tz, _) = te.train(0.1)
    return dict(xte=xte, yte=yte, je=je, jm=jm, jz=np.asarray(jz), te=te, tm=tm, tz=tz,
                fac_t=_fac_to_port(je.fac))


@pytest.fixture(scope="module")
def oneclass():
    """tests/test_golden.py::test_golden_oneclass_precision_recall_... on both."""
    xtr, _ = synthetic.blobs_with_outliers(1024, n_features=4, outlier_frac=0.1, seed=0)
    xte, yte = synthetic.blobs_with_outliers(512, n_features=4, outlier_frac=0.1, seed=1)
    kw = dict(leaf_size=128, task="oneclass")
    je = JEngine(spec=JSpec(h=2.0), comp=JParams(**COMP), max_it=30, **kw)
    je.prepare(xtr)
    jm, (jz, _) = je.train(0.1)
    te = TEngine(spec=TSpec(h=2.0), comp=TParams(**COMP), admm=tadmm.ADMMParams(max_it=30),
                 device="cpu", **kw)
    te.prepare(xtr)
    tm, (tz, _) = te.train(0.1)
    return dict(xte=xte, yte=yte, je=je, jm=jm, jz=np.asarray(jz), te=te, tm=tm, tz=tz)


@pytest.mark.parametrize("name", ["svr", "oneclass"])
def test_engine_matches_jax_engine(request, name):
    """Duals to 1e-4 of the box, bias to 1e-4, scores to 1e-4, the same
    iteration count; one-class predictions all equal."""
    t = request.getfixturevalue(name)
    box = 2.0 if name == "svr" else float(t["te"].problem_masks.sum()) ** -1 / 0.1
    np.testing.assert_allclose(t["tz"].numpy(), t["jz"], rtol=0, atol=1e-4 * box)
    np.testing.assert_allclose(t["tm"].biases.numpy(), np.asarray(t["jm"].biases),
                               rtol=0, atol=1e-4)
    js = np.asarray(t["jm"].decision_function(t["xte"]))
    np.testing.assert_allclose(t["tm"].decision_function(t["xte"]).numpy(), js,
                               rtol=0, atol=1e-4 * max(1.0, np.abs(js).max()))
    if name == "oneclass":
        np.testing.assert_array_equal(t["tm"].predict(t["xte"]).numpy(),
                                      np.asarray(t["jm"].predict(t["xte"])))
    assert t["te"].report.iters_run == t["je"].report.iters_run
    assert t["tm"].task == name and not t["tm"].binary


def test_golden_svr_rmse_noisy_sine_on_the_port(svr):
    """tests/test_golden.py::test_golden_svr_rmse_noisy_sine."""
    pred = svr["tm"].predict(svr["xte"]).numpy()
    rmse = float(np.sqrt(np.mean((pred - svr["yte"]) ** 2)))
    assert rmse < 0.12, rmse
    sv_frac = float((svr["tm"].z_y.abs() > 1e-5).float().mean())
    assert sv_frac < 0.8, sv_frac


def test_golden_oneclass_precision_recall_on_the_port(oneclass):
    """tests/test_golden.py::test_golden_oneclass_precision_recall_blobs_with_outliers."""
    m = ttasks.oneclass_metrics(oneclass["tm"].predict(oneclass["xte"]), oneclass["yte"])
    assert m["precision"] >= 0.65, m
    assert m["recall"] >= 0.90, m


def _tasks(je, kind):
    """A JAX BoxQPTask and the port's twin, on the SVR engine's d."""
    y = np.asarray(je.problem_labels)[0]
    mask = np.asarray(je.problem_masks)[0]
    d = y.shape[0]
    rng = np.random.default_rng(5)
    if kind == "svr-l1":
        return (jtasks.svr_task(jnp.asarray(y), 2.0 * jnp.asarray(mask), 0.1),
                ttasks.svr_task(torch.as_tensor(y), 2.0 * torch.as_tensor(mask), 0.1))
    if kind == "oneclass-eq_b":
        return (jtasks.one_class_task(jnp.asarray(mask), 0.2),
                ttasks.one_class_task(torch.as_tensor(mask), 0.2))
    # three problems, each with its own sign, equality vector and rhs, and an
    # ℓ1 weight: every generalized field at once
    k = 3
    f = np.float32
    sign = np.where(rng.random((d, k)) < 0.5, -1.0, 1.0).astype(f)
    fields = dict(sign=sign, lin=rng.normal(size=(d, k)).astype(f),
                  lo=-np.ones((d, k), f) * mask[:, None], hi=np.ones((d, k), f) * mask[:, None],
                  eq_sa=(sign * (1.0 + rng.random((d, k)))).astype(f),
                  eq_b=np.array([0.0, 0.5, -0.25], f), l1=np.array([0.0, 0.05, 0.2], f))
    return (jadmm.BoxQPTask(**{n: jnp.asarray(v) for n, v in fields.items()}),
            tadmm.BoxQPTask(**{n: torch.as_tensor(v) for n, v in fields.items()}))


@pytest.mark.parametrize("kind,tol,done0", [
    ("svr-l1", None, None),
    ("oneclass-eq_b", None, None),
    ("per-problem-eq_sa", None, None),
    ("per-problem-eq_sa", 1e-3, [True, False, False]),
    ("svr-l1", 5e-3, None),
])
def test_admm_boxqp_traces_match_on_shared_factorization(svr, kind, tol, done0):
    """The JAX factorization through both solvers: per-iteration residuals to
    1e-4 of their largest value, x/z/μ to 1e-5 relative, the same freeze."""
    je = svr["je"]
    jtask, ttask = _tasks(je, kind)
    k = jtask.sign.shape[1]
    d0j = None if done0 is None else jnp.asarray(done0)
    d0t = None if done0 is None else torch.as_tensor(done0)
    jst, jtr = jadmm.admm_boxqp(je.fac.solve_mat, jtask, je.fac.beta, 25, tol=tol, done0=d0j)
    tst, ttr = tadmm.admm_boxqp(svr["fac_t"].solve_mat, ttask, je.fac.beta, 25, tol=tol,
                                done0=d0t)
    for port, ref in ((ttr.primal_res, jtr.primal_res), (ttr.dual_res, jtr.dual_res)):
        ref = np.asarray(ref)
        assert port.shape == ref.shape == (25, k)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1e-3, float(np.abs(ref).max())))
    for port, ref in zip(tst, jst):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_array_equal(ttr.iters_run.numpy(), np.asarray(jtr.iters_run))
    if tol is None:
        assert ttr.done is None and jtr.done is None
    else:
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
    if done0 is not None:
        assert int(ttr.iters_run[0]) == 0 and bool(ttr.done[0])


def test_fused_update_refuses_the_l1_prox(svr):
    _, ttask = _tasks(svr["je"], "svr-l1")
    with pytest.raises(ValueError, match="gamma=0"):
        tadmm.admm_boxqp(svr["fac_t"].solve_mat, ttask, 10.0, 2, use_fused_update=True)


@pytest.mark.parametrize("name", ["svr", "oneclass"])
def test_bias_matches_jax_on_the_same_duals(request, name):
    """The SVR bias and the one-class ρ from the JAX duals: port HSS against
    JAX HSS (one matmat each), to 1e-4."""
    t = request.getfixturevalue(name)
    je, te = t["je"], t["te"]
    y = np.asarray(je.problem_labels).T
    mask = np.asarray(je.problem_masks).T
    z = t["jz"]
    if name == "svr":
        jb = jtasks.compute_bias_svr_batched(je.hss, jnp.asarray(y), jnp.asarray(z),
                                             2.0 * jnp.asarray(mask), jnp.asarray(mask), 0.1)
        tb = ttasks.compute_bias_svr_batched(te.hss, torch.as_tensor(y), torch.as_tensor(z),
                                             2.0 * torch.as_tensor(mask),
                                             torch.as_tensor(mask), 0.1)
    else:
        hi = mask / (0.1 * mask.sum())
        jb = jtasks.compute_rho_oneclass_batched(je.hss, jnp.asarray(z), jnp.asarray(hi),
                                                 jnp.asarray(mask))
        tb = ttasks.compute_rho_oneclass_batched(te.hss, torch.as_tensor(z),
                                                 torch.as_tensor(hi), torch.as_tensor(mask))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)


# tests/test_property.py's KKT bounds for ADMM at 800 iterations in f32.
_KKT_TOL = dict(stationarity=2e-2, eq=1e-3, box=1e-6, split=2e-4, comp_slack=1e-5)


@pytest.mark.parametrize("kind", ["svm", "svr", "oneclass"])
def test_kkt_residuals_of_the_ports_iterates(kind):
    """tests/proptest.py::kkt_residuals on the port's ADMM iterates, each task
    on a dense 128-point Gaussian kernel (the residuals measure ADMM
    optimality, not compression error)."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(128, 2)).astype(np.float32))
    k_mat = gaussian_block(x, x, 1.0)
    beta = 10.0
    lu = torch.linalg.lu_factor(k_mat.double() + beta * torch.eye(128, dtype=torch.float64))

    def solver(b):
        return torch.linalg.lu_solve(*lu, b.double()).float()

    if kind == "svm":
        y = torch.as_tensor(np.sign(rng.normal(size=(1, 128))).astype(np.float32))
        task = tadmm.svm_task(y, 1.0)
    elif kind == "svr":
        task = ttasks.svr_task(torch.sin(2.0 * x[:, 0]), 1.0, 0.1)
    else:
        task = ttasks.one_class_task(torch.ones(128), 0.2)
    state, _ = tadmm.admm_boxqp(solver, task, beta, max_it=800)
    res = pt.kkt_residuals(k_mat.numpy(), task, state)
    for name, bound in _KKT_TOL.items():
        assert np.all(res[name] <= bound), (kind, name, res[name])


def test_grid_searches_match_jax():
    """grid_search_svr / grid_search_oneclass: the same winning knob and
    scores within 1e-4 of the JAX grid searches'."""
    xtr, ytr, xva, yva = synthetic.train_test("noisy_sine", 512, 128, seed=2, noise=0.1)
    kw = dict(comp=COMP, leaf_size=128)
    _, jres = jtasks.grid_search_svr(xtr, ytr, xva, yva, [1.0], [0.05, 0.2], c_value=2.0,
                                     trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = ttasks.grid_search_svr(xtr, ytr, xva, yva, [1.0], [0.05, 0.2], c_value=2.0,
                                     trainer_kwargs=dict(kw, comp=TParams(**COMP),
                                                         device="cpu"))
    assert tres["best_c"] == jres["best_c"]
    for key, cell in jres["results"].items():
        assert abs(tres["results"][key]["accuracy"] - cell["accuracy"]) < 1e-4
    xtr, _ = synthetic.blobs_with_outliers(512, n_features=4, outlier_frac=0.1, seed=0)
    xva, yva = synthetic.blobs_with_outliers(256, n_features=4, outlier_frac=0.1, seed=1)
    _, jres = jtasks.grid_search_oneclass(xtr, xva, yva, [2.0], [0.1, 0.3],
                                          trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = ttasks.grid_search_oneclass(xtr, xva, yva, [2.0], [0.1, 0.3],
                                          trainer_kwargs=dict(kw, comp=TParams(**COMP),
                                                              device="cpu"))
    assert tres["best_c"] == jres["best_c"]
    for key, cell in jres["results"].items():
        assert abs(tres["results"][key]["accuracy"] - cell["accuracy"]) < 1e-4


def test_task_knobs_are_validated():
    te = TEngine(spec=TSpec(), task="oneclass", device="cpu")
    te.prepare(np.random.default_rng(0).normal(size=(300, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="nu"):
        te.train(1.5)
    with pytest.raises(ValueError, match="unknown task"):
        TEngine(spec=TSpec(), task="ranking", device="cpu").prepare(np.zeros((8, 2)))
