"""The port's host stages, compression and factorization against the JAX package.

Both packages get the same numpy points on the CPU, in f32.  The host numpy
stages (tree, padding, proxy sampling) must give identical index sets; the
skeletons chosen by pivoted QR are then identical too on these
non-degenerate blocks, and the HSS arrays and solves agree to f32 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import factorization as jfac
from repro.core import idqr as jidqr
from repro.core import tree as jtree
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.core import compression as tcomp
from repro_torch.core import factorization as tfac
from repro_torch.core import idqr as tidqr
from repro_torch.core import tree as ttree
from repro_torch.core.kernelfn import KernelSpec as TSpec
from repro_torch.data import synthetic as tsyn
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

N, LEAF, H = 480, 64, 1.0
PARAMS = dict(rank=16, n_near=16, n_far=24)


@pytest.fixture(scope="module")
def built():
    """The same 480 points (padded to 512, 3 levels) compressed by both."""
    x, y = jsyn.blobs(N, n_features=4, sep=1.6, seed=2)
    x_pad, _, _, levels = jtree.pad_dataset(x, y, LEAF)
    tree = jtree.build_tree(x_pad, LEAF, levels)
    xp = x_pad[tree.perm]
    jh = jcomp.compress(jnp.asarray(xp), tree, JSpec(h=H),
                        jcomp.CompressionParams(**PARAMS))
    ttree_ = ttree.build_tree(x_pad, LEAF, levels)
    with tcomp.counting_kernel_evals() as counter:
        th = tcomp.compress(xp, ttree_, TSpec(h=H), tcomp.CompressionParams(**PARAMS),
                            device="cpu")
    return dict(tree=tree, ttree=ttree_, xp=xp, jh=jh, th=th,
                counted=counter["count"])


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, ref, tol=1e-5):
    """|port - ref| <= tol * max(1, max|ref|): f32 rounding of O(1) arrays."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


# ------------------------------------------------------ host stages ---- #
@pytest.mark.parametrize("n,leaf,min_levels", [(480, 64, 0), (1000, 128, 0),
                                                (256, 32, 4), (700, 100, 0)])
def test_padding_and_tree_identical(n, leaf, min_levels):
    x, y = jsyn.blobs(n, n_features=3, seed=n)
    jx, jy, jm, jl = jtree.pad_dataset(x, y, leaf, min_levels=min_levels)
    tx, ty, tm, tl = ttree.pad_dataset(x, y, leaf, min_levels=min_levels)
    assert jl == tl and ttree.padded_size(n, leaf) == jtree.padded_size(n, leaf)
    for a, b in ((jx, tx), (jy, ty), (jm, tm)):
        np.testing.assert_array_equal(a, b)
    jt, tt = jtree.build_tree(jx, leaf, jl), ttree.build_tree(tx, leaf, tl)
    np.testing.assert_array_equal(jt.perm, tt.perm)
    np.testing.assert_array_equal(jt.inverse_perm(), tt.inverse_perm())


@pytest.mark.parametrize("name,kw", [("blobs", dict(sep=1.6, n_features=8)),
                                     ("susy_like", dict(n_features=8)),
                                     ("circles", {}), ("checkerboard", {})])
def test_synthetic_data_identical(name, kw):
    for a, b in zip(jsyn.train_test(name, 300, 50, seed=4, **kw),
                    tsyn.train_test(name, 300, 50, seed=4, **kw)):
        np.testing.assert_array_equal(a, b)


def test_proxy_indices_identical(built):
    tree, tt, xp = built["tree"], built["ttree"], built["xp"]
    jp, tp = jcomp.CompressionParams(**PARAMS), tcomp.CompressionParams(**PARAMS)
    for a, b in zip(jcomp._host_proxy_indices(tree, jp),
                    tcomp._host_proxy_indices(tt, tp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jcomp._host_leaf_near(tree, jp, xp),
                                  tcomp._host_leaf_near(tt, tp, xp))
    np.testing.assert_array_equal(jcomp._host_leaf_near(tree, jp),
                                  tcomp._host_leaf_near(tt, tp))


# ------------------------------------------------------ idqr ---------- #
@pytest.mark.parametrize("s,n,k", [(20, 30, 6), (37, 50, 12), (9, 9, 9)])
def test_row_interp_decomp_matches_reference(s, n, k):
    """Pivots equal; P to 1e-5 of its largest entry (f32 reorderings)."""
    rng = np.random.default_rng(s * n + k)
    m = rng.normal(size=(n, s)).astype(np.float32)
    jpiv, jp = jidqr.row_interp_decomp(jnp.asarray(m), k)
    tpiv, tp = tidqr.row_interp_decomp(torch.as_tensor(m), k)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    _close(tp, jp)


def test_idqr_batch_equals_per_matrix():
    """The written-out batch dimension computes each matrix as alone."""
    rng = np.random.default_rng(3)
    m = torch.as_tensor(rng.normal(size=(4, 12, 20)).astype(np.float32))
    piv, t = tidqr.interp_decomp(m, 5)
    for i in range(4):
        p1, t1 = tidqr.interp_decomp(m[i], 5)
        torch.testing.assert_close(piv[i], p1, rtol=0, atol=0)
        torch.testing.assert_close(t[i], t1, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ compression ---- #
def test_skeletons_identical(built):
    jh, th = built["jh"], built["th"]
    np.testing.assert_array_equal(th.skel_leaf.numpy(), np.asarray(jh.skel_leaf))
    assert len(th.skels) == len(jh.skels) == th.levels - 1
    for a, b in zip(th.skels, jh.skels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_hss_arrays_close(built):
    jh, th = built["jh"], built["th"]
    assert th.ranks == jh.ranks and th.levels == jh.levels
    _close(th.d_leaf, jh.d_leaf)
    _close(th.u_leaf, jh.u_leaf)
    for group in ("transfers", "b_mats"):
        port, ref = getattr(th, group), getattr(jh, group)
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _close(a, b)


def test_matmat_matches_reference_and_todense(built):
    jh, th = built["jh"], built["th"]
    v = np.random.default_rng(0).normal(size=(th.n, 3)).astype(np.float32)
    out = th.matmat(torch.as_tensor(v))
    _close(out, jh.matmat(jnp.asarray(v)))
    _close(out, th.todense() @ torch.as_tensor(v))
    _close(th.matvec(torch.as_tensor(v[:, 0])), out[:, 0])
    _close(th.todense(), jh.todense())


def test_kernel_eval_count_and_memory_identical(built):
    tree, jh, th = built["tree"], built["jh"], built["th"]
    want = jcomp.kernel_eval_count(tree, jcomp.CompressionParams(**PARAMS))
    assert tcomp.kernel_eval_count(built["ttree"], tcomp.CompressionParams(**PARAMS)) == want
    assert built["counted"] == want
    assert th.memory_bytes() == jh.memory_bytes()
    assert th.stored_rank_sum() == jh.stored_rank_sum()
    assert th.rank_masks() is None


def test_hss_convert_roundtrip(built):
    jh = built["jh"]
    arrays = {f: np.asarray(getattr(jh, f)) for f in
              ("x", "d_leaf", "u_leaf", "skel_leaf")}
    groups = {f: [np.asarray(a) for a in getattr(jh, f)]
              for f in ("transfers", "skels", "b_mats")}
    th = convert.hss_from_numpy(**arrays, **groups, levels=jh.levels,
                                leaf_size=jh.leaf_size, device="cpu")
    for f, a in arrays.items():
        np.testing.assert_array_equal(getattr(th, f).numpy(), a)
    for f, lst in groups.items():
        for a, b in zip(getattr(th, f), lst):
            np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------ factorization -- #
def _port_hss_of(jh):
    return convert.hss_from_numpy(
        **{f: np.asarray(getattr(jh, f)) for f in ("x", "d_leaf", "u_leaf", "skel_leaf")},
        **{f: [np.asarray(a) for a in getattr(jh, f)]
           for f in ("transfers", "skels", "b_mats")},
        levels=jh.levels, leaf_size=jh.leaf_size, device="cpu")


@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_factorize_and_solve_match_reference(built, beta):
    """The JAX HSS through the port's factorize: factors and solves agree
    with the JAX factorization to f32 rounding (relative 1e-5)."""
    jh = built["jh"]
    jf = jfac.factorize(jh, beta)
    tf = tfac.factorize(_port_hss_of(jh), beta)
    _close(tf.e_leaf, jf.e_leaf)
    _close(tf.g_leaf, jf.g_leaf)
    for a, b in zip(tf.e_lvls + tf.g_lvls, jf.e_lvls + jf.g_lvls):
        _close(a, b)
    b = np.random.default_rng(1).normal(size=(jh.n, 2)).astype(np.float32)
    ref = np.asarray(jf.solve_mat(jnp.asarray(b)))
    rel = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(tf.solve_mat(torch.as_tensor(b)).numpy(), ref,
                               rtol=0, atol=rel)
    np.testing.assert_allclose(tf.solve(torch.as_tensor(b[:, 0])).numpy(),
                               ref[:, 0], rtol=0, atol=rel)
    # The JAX factorization carried across solves the same way.
    jf_t = convert.factorization_from_numpy(
        e_leaf=np.asarray(jf.e_leaf), g_leaf=np.asarray(jf.g_leaf),
        e_lvls=[np.asarray(a) for a in jf.e_lvls],
        g_lvls=[np.asarray(a) for a in jf.g_lvls],
        root_lu=np.asarray(jf.root_lu), root_piv=np.asarray(jf.root_piv),
        levels=jf.levels, leaf_size=jf.leaf_size, beta=jf.beta, device="cpu")
    np.testing.assert_allclose(jf_t.solve_mat(torch.as_tensor(b)).numpy(), ref,
                               rtol=0, atol=rel)


@pytest.mark.parametrize("beta", [1.0, 10.0, 100.0])
def test_solve_is_the_dense_inverse(built, beta):
    """The identity tests/test_factorization.py checks on the reference: the
    telescoping solve equals a dense solve of todense() + beta I (same 1e-3
    bound), and inverts the HSS matvec."""
    th = built["th"]
    tf = tfac.factorize(th, beta)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=th.n).astype(np.float32))
    x = tf.solve(b)
    dense = th.todense() + beta * torch.eye(th.n)
    x_dense = torch.linalg.solve(dense, b)
    assert float(torch.linalg.norm(x - x_dense) / torch.linalg.norm(x_dense)) < 1e-3
    back = th.matvec(x) + beta * x
    assert float(torch.linalg.norm(back - b) / torch.linalg.norm(b)) < 1e-4
