"""The port's baselines against the JAX package's, on the CPU.

``repro.core.baselines`` and ``repro_torch.core.baselines`` on the same
512 training points of ``bench_baselines.py``'s data (circles, 4
features, gap 0.8, seed 1; h 1, C 1, β 100) and 256 test points.

Tolerances: z within 1e-4·C and the bias within 1e-4 (f32 K, Cholesky
and solves in other orders through 10 ADMM iterations: the box clip keeps
the error near the f32 residual of K + βI, cond ≲ 6; measured here 2.0e-6
and 4.4e-6 dense, 1.6e-5 and 3.9e-5 Nyström, whose W^{-1/2} amplifies
eigh's rounding on W's small eigenvalues); test predictions
equal but for at most 1 in 256, on a point whose score is within 1e-3 of
0.  SMO runs in f64 on the host in both packages: α and the bias equal to
1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core.kernelfn import KernelSpec as JSpec
from repro_torch.core import baselines as pb
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.data import synthetic
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

H, C, BETA, N = 1.0, 1.0, 100.0, 512
Z_ATOL, BIAS_ATOL, SCORE_BAND = 1e-4 * C, 1e-4, 1e-3


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = synthetic.train_test("circles", N, 256, seed=1, n_features=4,
                                              gap=0.8)
    return xtr, ytr, xte, yte


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _scores(xtr, ytr, z, b, xte):
    """Exact (f64) decision values, to tell a flip on the boundary."""
    d2 = ((xte[:, None, :].astype(np.float64) - xtr[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2 * H * H)) @ (ytr * np.asarray(z, np.float64)) + float(b)


def _hold(data, z_p, b_p, z_j, b_j):
    xtr, ytr, xte, _ = data
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), rtol=0, atol=Z_ATOL)
    assert abs(float(b_p) - float(b_j)) <= BIAS_ATOL
    p_p = pb.dense_predict(_t(xtr), _t(ytr), z_p, b_p, KernelSpec(h=H), _t(xte)).numpy()
    p_j = np.asarray(jb.dense_predict(jnp.asarray(xtr), jnp.asarray(ytr), z_j, b_j,
                                      JSpec(h=H), jnp.asarray(xte)))
    off = p_p != p_j
    assert off.sum() <= 1
    assert (np.abs(_scores(xtr, ytr, z_j, b_j, xte))[off] <= SCORE_BAND).all()
    return p_p


def test_dense_admm_and_predict_match_the_reference(data):
    xtr, ytr, xte, yte = data
    z_j, b_j = jb.dense_admm_fit(jnp.asarray(xtr), jnp.asarray(ytr), JSpec(h=H), C, BETA)
    z_p, b_p = pb.dense_admm_fit(_t(xtr), _t(ytr), KernelSpec(h=H), C, BETA)
    assert z_p.dtype == torch.float32 and z_p.shape == (N,)
    pred = _hold(data, z_p, b_p, z_j, b_j)
    assert np.mean(pred == yte) > 0.8


def test_dense_bias_branches_match_the_reference():
    """The margin branch and the all-SV fallback (no margin SV)."""
    r = np.random.default_rng(0)
    a = r.normal(size=(64, 64)).astype(np.float32)
    k = (a @ a.T / 64).astype(np.float32)
    y = np.where(r.random(64) > 0.5, 1.0, -1.0).astype(np.float32)
    for z in (r.uniform(0, 1, 64).astype(np.float32),
              np.where(r.random(64) > 0.5, 1.0, 0.0).astype(np.float32)):
        want = float(jb._dense_bias(jnp.asarray(k), jnp.asarray(y), jnp.asarray(z), 1.0))
        got = float(pb._dense_bias(_t(k), _t(y), _t(z), 1.0))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_nystrom_admm_matches_the_reference_on_its_landmarks(data):
    xtr, ytr, _, yte = data
    k = 256
    lm = np.asarray(jax.random.choice(jax.random.PRNGKey(0), N, (k,), replace=False))
    z_j, b_j = jb.nystrom_admm_fit(jnp.asarray(xtr), jnp.asarray(ytr), JSpec(h=H), C, BETA,
                                   n_landmarks=k, seed=0)
    z_p, b_p = pb.nystrom_admm_fit(_t(xtr), _t(ytr), KernelSpec(h=H), C, BETA,
                                   n_landmarks=k, landmarks=lm)
    pred = _hold(data, z_p, b_p, z_j, b_j)
    assert np.mean(pred == yte) > 0.8
    # without landmarks the port draws them from default_rng(seed)
    drawn = pb.nystrom_landmarks(N, k, seed=3)
    assert len(set(drawn.tolist())) == k and drawn.max() < N
    z_d, _ = pb.nystrom_admm_fit(_t(xtr), _t(ytr), KernelSpec(h=H), C, BETA,
                                 n_landmarks=k, seed=3)
    z_e, _ = pb.nystrom_admm_fit(_t(xtr), _t(ytr), KernelSpec(h=H), C, BETA,
                                 n_landmarks=k, landmarks=drawn)
    assert torch.equal(z_d, z_e)


def test_smo_matches_the_reference(data):
    xtr, ytr, _, _ = data
    a_j, b_j, it_j = jb.smo_fit(xtr, ytr, JSpec(h=H), C, max_iter=4000)
    a_p, b_p, it_p = pb.smo_fit(xtr, ytr, KernelSpec(h=H), C, max_iter=4000)
    assert it_p == it_j
    np.testing.assert_allclose(a_p, a_j, rtol=0, atol=1e-12)
    assert abs(b_p - b_j) <= 1e-12
