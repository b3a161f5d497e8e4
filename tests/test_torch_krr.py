"""The port's kernel linear algebra (KRR, GP, Lanczos) against the JAX package.

The same numpy data, start vector and Hutchinson probes go through the JAX
functions and the port's on the CPU: the KRR / GP engines (α, scores, the
per-λ refactorization), ``lanczos``/``top_eigenpairs`` with the same ``v0``,
``gp_log_marginal`` with the same probes, ``spectral_embed`` in input order,
and the grid searches.  Tolerances: α and scores to 1e-4 of their largest
value (the two builds' HSS arrays agree to ~1e-5, and (K̃ + λI)⁻¹ at λ 0.5
amplifies that); Lanczos coefficients and eigenvalues to 1e-4 relative,
eigenvectors to 1e-3 up to sign; log marginals to 1e-4 relative with the
same probes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import krr as jkrr
from repro.core import lanczos as jlanczos
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch.core import krr as tkrr
from repro_torch.core import lanczos as tlanczos
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

COMP = dict(rank=32, n_near=48, n_far=64)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


@pytest.fixture(scope="module")
def engines():
    """tests/test_krr.py's golden KRR problem, on task "gp" (the same solve;
    ``log_marginal`` on top), λ 0.5 then 2.0 on one compression."""
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", 1024, 256, seed=0, noise=0.1)
    je = JEngine(spec=JSpec(h=1.0), comp=JParams(**COMP), leaf_size=128, task="gp")
    je.prepare(xtr, ytr)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams(**COMP), leaf_size=128, task="gp",
                 device="cpu")
    te.prepare(xtr, ytr)
    out = dict(xte=xte, yte=yte, je=je, te=te, models={})
    for lam in (0.5, 2.0):
        f0 = te.report.factorization_s
        jm, _ = je.train(lam)
        tm, _ = te.train(lam)
        out["models"][lam] = (jm, tm, te.report.factorization_s - f0)
    return out


@pytest.mark.parametrize("lam", [0.5, 2.0])
def test_gp_engine_matches_jax_engine(engines, lam):
    jm, tm, dfac = engines["models"][lam]
    assert _rel(tm.z_y.numpy(), np.asarray(jm.z_y)) <= 1e-4
    js = np.asarray(jm.predict(jnp.asarray(engines["xte"])))
    assert _rel(tm.predict(engines["xte"]).numpy(), js) <= 1e-4
    assert tm.task == "gp" and tm.beta == jm.beta == lam and not tm.binary
    assert float(tm.biases.abs().max()) == 0.0
    assert engines["te"].report.iters_run == engines["je"].report.iters_run == (0,)
    assert dfac > 0.0                       # each new λ refactorizes once
    assert set(engines["te"]._fac_cache) == {100.0, 0.5, 2.0}    # prepare's β, each λ
    fac = engines["te"]._fac_cache[lam]
    engines["te"].train(lam)                # a visited λ reuses its factorization
    assert len(engines["te"]._fac_cache) == 3 and engines["te"]._fac_for(lam) is fac


def test_golden_krr_noise_floor_on_the_port():
    """tests/test_krr.py::test_golden_krr_noise_floor_zero_admm_iterations."""
    xtr, ytr, xte, yte = synthetic.train_test("noisy_sine", 1024, 256, seed=0, noise=0.1)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams(**COMP), leaf_size=128, task="krr",
                 device="cpu")
    te.prepare(xtr, ytr)
    model, _ = te.train(0.5)
    assert te.report.iters_run == (0,)
    rmse = float(np.sqrt(np.mean((model.predict(xte).numpy() - yte) ** 2)))
    assert rmse < 0.12, rmse
    with pytest.raises(ValueError, match="lambda"):
        te.train(0.0)


def test_lanczos_and_top_eigenpairs_with_the_same_start(engines):
    """The same v0 (the JAX package's seed-0 draw) through both: the
    tridiagonal to 1e-4, the top 6 eigenpairs to 1e-4 / 1e-3 up to sign."""
    je, te = engines["je"], engines["te"]
    n = te.hss.n
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    ja, jb, _ = jlanczos.lanczos(je.hss.matvec, jnp.asarray(v0), 24)
    ta, tb, basis = tlanczos.lanczos(te.hss.matvec, torch.as_tensor(v0), 24)
    assert _rel(ta.numpy(), np.asarray(ja)) <= 1e-4
    assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-4
    gram = (basis[:24] @ basis[:24].T).numpy()
    assert np.abs(gram - np.eye(24)).max() <= 1e-5       # full reorthogonalization
    jev, jvec = jlanczos.top_eigenpairs(je.hss, 6)
    tev, tvec = te.top_eigenpairs(6, v0=torch.as_tensor(v0))
    assert _rel(tev.numpy(), np.asarray(jev)) <= 1e-4
    assert np.all(np.diff(tev.numpy()) <= 0)
    jvec = np.asarray(jvec)
    sign = np.sign((tvec.numpy() * jvec).sum(0))
    assert np.abs(tvec.numpy() * sign - jvec).max() <= 1e-3
    # Ritz residuals through the port's own operator
    kv = te.hss.matmat(tvec)
    assert float(((kv - tvec * tev).norm(dim=0) / tev.abs()).max()) <= 1e-4


def test_gp_log_marginal_with_the_same_probes(engines):
    """The JAX package's seed-0 Rademacher probes through both estimators:
    the log marginal to 1e-4 relative, pad correction included."""
    je, te = engines["je"], engines["te"]
    n = te.hss.n
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    probes = np.stack([np.asarray(jax.random.rademacher(k, (n,), jnp.float32)) for k in keys])
    want = je.log_marginal(0.5, n_probes=4, num_iters=20, seed=0)
    got = te.log_marginal(0.5, num_iters=20, probes=torch.as_tensor(probes))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    direct = tkrr.gp_log_marginal(te.hss, te._fac_for(0.5), te.problem_labels[0],
                                  mask=te.problem_masks[0], num_iters=20,
                                  probes=torch.as_tensor(probes))
    assert direct == got
    seeded = te.log_marginal(0.5, n_probes=4, num_iters=20, seed=3)
    assert np.isfinite(seeded) and abs(seeded - want) <= 0.1 * abs(want)


def test_spectral_embed_in_input_order_matches_jax():
    """Circles at h 0.25: the port's embedding of the original rows against
    the JAX engine's, with the same v0, up to column signs, to 5e-3 of the
    largest coordinate: the two builds' operators differ by ~1e-5 of their
    norm, and the eigenvalues 42.0, 35.8, 34.2, 32.3 sit 5% apart, which
    moves the Ritz vectors ~100x more (measured 1.4e-3)."""
    xtr, ytr, _, _ = synthetic.train_test("circles", 900, 64, seed=0, n_features=2)
    je = JEngine(spec=JSpec(h=0.25), comp=JParams(**COMP), leaf_size=128)
    je.prepare(xtr, ytr)
    te = TEngine(spec=TSpec(h=0.25), comp=TParams(**COMP), leaf_size=128, device="cpu")
    te.prepare(xtr, ytr)
    v0 = jax.random.normal(jax.random.PRNGKey(0), (te.hss.n,), jnp.float32)
    jemb = je.spectral_embed(3)
    temb = te.spectral_embed(3, v0=torch.as_tensor(np.asarray(v0)))
    assert temb.shape == jemb.shape == (900, 3)
    sign = np.sign((temb * jemb).sum(0))
    assert np.abs(temb * sign - jemb).max() <= 5e-3 * np.abs(jemb).max()


def test_grid_searches_match_jax():
    xtr, ytr, xva, yva = synthetic.train_test("noisy_sine", 512, 128, seed=2, noise=0.1)
    kw = dict(leaf_size=128)
    _, jres = jkrr.grid_search_krr(xtr, ytr, xva, yva, [1.0], [0.1, 1.0],
                                   trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = tkrr.grid_search_krr(xtr, ytr, xva, yva, [1.0], [0.1, 1.0],
                                   trainer_kwargs=dict(kw, comp=TParams(**COMP), device="cpu"))
    assert tres["best_c"] == jres["best_c"]
    for key, cell in jres["results"].items():
        assert abs(tres["results"][key]["accuracy"] - cell["accuracy"]) <= 1e-4
    _, jres = jkrr.grid_search_gp(xtr, ytr, [1.0], [0.1, 1.0], num_iters=15,
                                  trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = tkrr.grid_search_gp(xtr, ytr, [1.0], [0.1, 1.0], num_iters=15,
                                  trainer_kwargs=dict(kw, comp=TParams(**COMP), device="cpu"))
    assert tres["best_lam"] == jres["best_lam"]
    for key, cell in jres["results"].items():
        # different probes (jax.random against torch.Generator; with the
        # same probes the two agree to 1e-4, above): the same estimate to
        # the Monte-Carlo spread of 4 probes, which spans ~17 across seeds
        # 0-2 here, so 0.03 per real point
        assert abs(tres["results"][key]["log_marginal"] - cell["log_marginal"]) \
            <= 0.03 * xtr.shape[0]


def test_padded_gp_keeps_its_pads_inert():
    """20,000 points pad to 32,768: the pads far out (~1e7·diam) make f32
    cancellation noise of their Gaussian entries, and the raw build's
    K̃ + λI at λ 0.5 is indefinite (its leaf Cholesky fails; the JAX
    package's returns NaN).  The engine's build has an exact identity pad
    block, solves, gives its pads zero weight, and its solve's backward
    error stays at chip_smoke.py's [gp] bound (1e-2)."""
    from repro_torch.core import compression, factorization, tree as ttree
    from repro_torch.core.hss import shrink_report

    xtr, ytr, _, _ = synthetic.train_test("noisy_sine", 20000, 64, seed=0, noise=0.1)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams.crude(), leaf_size=256, task="gp",
                 device="cpu")
    te.prepare(xtr, ytr)
    real = te.problem_masks[0] > 0
    pl = (~real).reshape(-1, 256)
    d = te.hss.d_leaf[pl.any(1)]
    pp = pl[pl.any(1)]
    blk = d[pp[:, :, None] & pp[:, None, :]].reshape(-1)
    assert blk.numel() > 0 and set(blk.unique().tolist()) == {0.0, 1.0}
    model, (alpha, _) = te.train(0.5)
    assert bool(torch.isfinite(alpha).all()) and float(alpha[~real].abs().max()) == 0.0
    y = te.problem_labels[0]
    r = (te.hss.matvec(alpha[:, 0]) + 0.5 * alpha[:, 0] - y)[real].norm()
    theta = te.top_eigenpairs(1)[0][0]
    assert float(r / ((theta + 0.5) * alpha.norm() + y[real].norm())) <= 1e-2
    # the raw build, as the reference's: not positive definite at λ 0.5 —
    # a leaf's Cholesky fails, and its factors come back NaN, as the
    # reference's jsl.cholesky gives them (no raise: that would read the
    # info back to the host)
    x_pad, _, _, levels = ttree.pad_dataset(xtr, ytr, 256)
    t = ttree.build_tree(x_pad, 256, levels)
    raw, _ = shrink_report(compression.compress(x_pad[t.perm], t, TSpec(h=1.0),
                                                TParams.crude(), device="cpu"))
    fac_raw = factorization.factorize(raw, 0.5)
    failed = torch.isnan(fac_raw.e_leaf).flatten(1).all(1)
    assert bool(failed.any()) and bool(torch.isnan(fac_raw.g_leaf[failed]).all())
