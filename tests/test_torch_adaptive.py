"""The port's adaptive-rank build, laplacian kernel and bf16 factor storage
against the JAX package, on the CPU.

Both packages get the same numpy points in f32.  The adaptive builds run
both presets of the paper (``CompressionParams.crude()``/``.accurate()``),
scaled down to 1024 points of 2-feature circles at leaf 64 (16 leaves, 4
levels), with both kernels.  Ranks and live skeletons must be identical;
arrays, shrunk-vs-full products and solves agree to f32 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import factorization as jfac
from repro.core import hss as jhss
from repro.core import idqr as jidqr
from repro.core import tree as jtree
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import admm as tadmm
from repro_torch.core import compression as tcomp
from repro_torch.core import factorization as tfac
from repro_torch.core import hss as thss
from repro_torch.core import idqr as tidqr
from repro_torch.core import tree as ttree
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

F32_EPS = float(np.finfo(np.float32).eps)
LEAF = 64
H = {"gaussian": 1.5, "laplacian": 2.0}
CASES = [(name, preset) for name in H for preset in ("crude", "accurate")]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(port, ref, tol=1e-5):
    """|port - ref| <= tol * max(1, max|ref|): f32 rounding of O(1) arrays."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def _rel(port, ref):
    port, ref = _np(port), _np(ref)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def built(request):
    """One kernel × preset, compressed by both packages."""
    name, preset = request.param
    h = H[name]
    x, y = synthetic.circles(1024, n_features=2, seed=0, gap=0.8)
    x_pad, _, _, levels = jtree.pad_dataset(x, y, LEAF)
    tree = jtree.build_tree(x_pad, LEAF, levels)
    xp = x_pad[tree.perm]
    jp, tp = getattr(JParams, preset)(), getattr(TParams, preset)()
    jh = jcomp.compress(jnp.asarray(xp), tree, JSpec(name=name, h=h), jp)
    ttree_ = ttree.build_tree(x_pad, LEAF, levels)
    th = tcomp.compress(xp, ttree_, TSpec(name, h), tp, device="cpu")
    return dict(spec=TSpec(name, h), rtol=tp.rtol, tree=tree, jp=jp, tp=tp,
                ttree=ttree_, jh=jh, th=th)


def _rank_vectors(h):
    return [_np(r) for r in (h.leaf_ranks, *h.level_ranks)]


def _live(ranks, width):
    return np.arange(width)[None, :] < np.asarray(ranks)[:, None]


def _port_hss_of(jh):
    return convert.hss_from_numpy(
        **{f: np.asarray(getattr(jh, f)) for f in ("x", "d_leaf", "u_leaf", "skel_leaf")},
        **{f: [np.asarray(a) for a in getattr(jh, f)]
           for f in ("transfers", "skels", "b_mats", "level_ranks")},
        leaf_ranks=None if jh.leaf_ranks is None else np.asarray(jh.leaf_ranks),
        levels=jh.levels, leaf_size=jh.leaf_size, device="cpu")


def test_leaf_level_identical(built):
    """The leaf level end to end: ranks and live skeletons (slot < rank)
    identical, D and the level-1 couplings B to 1e-5.  A slot past its
    node's rank holds a pivot chosen among residual columns at f32 noise
    level: it is no skeleton (its basis column is 0) and may differ — the
    reference's own XLA and Pallas paths differ there too.

    The bases U are T = R_J⁻¹R, where R_J's condition number reaches 1/rtol:
    f32 rounding (eps) grows by up to that factor, so U is held to
    max(1e-5, eps/rtol) — 1e-5 at the crude preset, 1.2e-3 at the accurate
    one (5.2e-4 measured there with the gaussian kernel).  The operator is
    held to 1e-5 below."""
    jh, th = built["jh"], built["th"]
    assert th.adaptive and jh.adaptive
    assert th.ranks == jh.ranks and th.levels == jh.levels
    np.testing.assert_array_equal(_np(th.leaf_ranks), _np(jh.leaf_ranks))
    live = _live(_np(jh.leaf_ranks), jh.skel_leaf.shape[1])
    np.testing.assert_array_equal(_np(th.skel_leaf)[live], _np(jh.skel_leaf)[live])
    _close(th.d_leaf, jh.d_leaf)
    _close(th.b_mats[0], jh.b_mats[0])
    _close(th.u_leaf, jh.u_leaf, max(1e-5, F32_EPS / built["rtol"]))


def test_each_level_matches_reference_on_its_inputs(built):
    """Every upper level, fed the reference build's own inputs (the child
    skeletons and ranks it chose, the same far proxies): identical ranks
    and live skeleton sets on every node, the same pivot order on all but
    at most one node per level, and on those nodes the transfers as in the
    leaf test; the couplings B to 1e-5.

    Stage by stage because the reference passes the sibling's dead slots on
    as NEAR proxies of the next level (ROADMAP queue 3): those noise-chosen
    points make an end-to-end build's upper levels depend on rounding.  The
    order may flip where two residual norms tie to f32 rounding: at the
    accurate preset's laplacian level 2, node 0 takes slots 39 and 40 in
    swapped order (|R_ii|/|R_00| = 2.10e-3 and 2.07e-3 once chosen)."""
    jh, tp, spec, x = built["jh"], built["tp"], built["spec"], built["th"].x
    far = tcomp._host_proxy_indices(built["ttree"], tp)
    basis_tol = max(1e-5, F32_EPS / built["rtol"])
    skel_prev, rank_prev = _np(jh.skel_leaf), _np(jh.leaf_ranks)
    for k in range(1, jh.levels):
        r_prev = skel_prev.shape[1]
        n_k = skel_prev.shape[0] // 2
        cand = torch.as_tensor(skel_prev.reshape(n_k, 2 * r_prev)).long()
        cmask = tcomp._cand_mask(torch.as_tensor(rank_prev), r_prev, torch.float32)
        sib = cand.reshape(n_k // 2, 2, 2 * r_prev).flip(1).reshape(n_k, 2 * r_prev)
        prox = torch.cat([sib, torch.as_tensor(far[k]).long()], dim=1)
        r_k = jh.transfers[k - 1].shape[-1]
        piv, t_k, rank_k = tcomp._batched_row_id(spec, x[cand], x[prox], r_k,
                                                 tp.rtol, True, cmask=cmask)
        want_rank, want_skel = _np(jh.level_ranks[k - 1]), _np(jh.skels[k - 1])
        np.testing.assert_array_equal(rank_k.numpy(), want_rank)
        skel = torch.gather(cand, 1, piv.long()).numpy()
        same = []
        for i, r in enumerate(want_rank):
            assert sorted(skel[i, :r]) == sorted(want_skel[i, :r]), (k, i)
            same.append(bool((skel[i, :r] == want_skel[i, :r]).all()))
        assert sum(same) >= n_k - 1, (k, same)
        _close(t_k[same], _np(jh.transfers[k - 1])[same], basis_tol)
        b_k = tcomp._mask_b(tcomp._batched_kernel_block(
            spec, x[cand[:, :r_prev]], x[cand[:, r_prev:]]), cmask, r_prev)
        _close(b_k, jh.b_mats[k - 1])
        skel_prev, rank_prev = want_skel, want_rank


def test_masked_slots_are_structural_zeros(built):
    """Everything past a node's rank is exactly 0 in the port's own build:
    u_leaf/transfer columns, transfer rows of dead child slots, B
    rows/columns of dead skeletons."""
    th = built["th"]
    leaf_r, *lvl_r = _rank_vectors(th)
    u = _np(th.u_leaf)
    for i, r in enumerate(leaf_r):
        assert not u[i, :, r:].any(), i
    for k, t in enumerate(th.transfers):
        t, rp = _np(t), t.shape[1] // 2
        child = (leaf_r if k == 0 else lvl_r[k - 1]).reshape(-1, 2)
        for i in range(t.shape[0]):
            assert not t[i, :, lvl_r[k][i]:].any()
            assert not t[i, child[i, 0]:rp, :].any()
            assert not t[i, rp + child[i, 1]:, :].any()
    for k, b in enumerate(th.b_mats):
        b = _np(b)
        child = (leaf_r if k == 0 else lvl_r[k - 1]).reshape(-1, 2)
        for i in range(b.shape[0]):
            assert not b[i, child[i, 0]:, :].any()
            assert not b[i, :, child[i, 1]:].any()


def test_shrink_report_and_memory_identical(built):
    """shrink_report of the reference's HSS in the port equals the
    reference's; the port's own build has the reference's caps, storage and
    kernel-evaluation count."""
    jh, th = built["jh"], built["th"]
    js, jinfo = jhss.shrink_report(jh)
    ts, tinfo = thss.shrink_report(_port_hss_of(jh))
    assert tinfo == jinfo
    assert ts.ranks == js.ranks == jh.observed_ranks()
    assert ts.memory_bytes() == js.memory_bytes()
    assert th.memory_bytes() == jh.memory_bytes()
    assert thss.shrink_report(th)[1]["rank_sum_pre"] == jinfo["rank_sum_pre"]
    assert tcomp.kernel_eval_count(built["ttree"], built["tp"]) == \
        jcomp.kernel_eval_count(built["tree"], built["jp"])


def test_shrunk_vs_full_matmat_and_solve(built):
    """tests/test_adaptive.py's exactness bar on the port's own build
    (shrunk against full ≤ 1e-5, matmat and solve), and the port's shrink
    of the reference's HSS against the reference's."""
    jh, th = built["jh"], built["th"]
    ts = thss.shrink_to_fit(th)
    v = np.random.default_rng(1).normal(size=(th.n, 4)).astype(np.float32)
    vt = torch.as_tensor(v)
    assert _rel(ts.matmat(vt), th.matmat(vt)) <= 1e-5
    assert _rel(thss.shrink_to_fit(_port_hss_of(jh)).matmat(vt),
                jhss.shrink_to_fit(jh).matmat(jnp.asarray(v))) <= 1e-5
    s_full = tfac.factorize(th, 20.0).solve_mat(vt)
    s_shr = tfac.factorize(ts, 20.0).solve_mat(vt)
    assert _rel(s_shr, s_full) <= 1e-5
    resid = ts.matmat(s_shr) + 20.0 * s_shr - vt
    assert float(torch.linalg.norm(resid) / torch.linalg.norm(vt)) < 1e-4


def test_shrink_multiple_rounding(built):
    th = built["th"]
    shr8 = thss.shrink_to_fit(th, multiple=8)
    assert all(r % 8 == 0 or r == c for r, c in zip(shr8.ranks, th.ranks))
    assert all(r >= o for r, o in zip(shr8.ranks, th.observed_ranks()))
    v = torch.as_tensor(np.random.default_rng(2).normal(size=(th.n, 2)).astype(np.float32))
    assert _rel(shr8.matmat(v), th.matmat(v)) <= 1e-5


def test_masked_and_bf16_factorization_match_reference(built):
    """The JAX adaptive HSS (unshrunk: the masks are live) through the
    port's factorize.  f32 storage: solve to 1e-5.  bf16 storage, against
    the reference's factorize(store_dtype="bfloat16"): both round nearly
    equal f32 factors to bf16, and an entry within f32 noise of a rounding
    boundary can land one bf16 step (2^-8 relative) apart, so the solves
    are held to 1e-3; each stays within bf16 storage rounding (1e-2) of the
    f32 solve, the bar of tests/test_factorization.py."""
    jh = built["jh"]
    th = _port_hss_of(jh)
    assert th.adaptive and th.rank_masks() is not None
    v = np.random.default_rng(3).normal(size=(jh.n, 3)).astype(np.float32)
    vt = torch.as_tensor(v)
    ref32 = np.asarray(jfac.factorize(jh, 10.0).solve_mat(jnp.asarray(v)))
    out32 = tfac.factorize(th, 10.0).solve_mat(vt)
    assert _rel(out32, ref32) <= 1e-5
    f16 = tfac.factorize(th, 10.0, store_dtype="bfloat16")
    assert f16.e_leaf.dtype == torch.bfloat16 and f16.root_lu.dtype == torch.float32
    out16 = f16.solve_mat(vt)
    assert out16.dtype == torch.float32
    ref16 = np.asarray(jfac.factorize(jh, 10.0, store_dtype="bfloat16")
                       .solve_mat(jnp.asarray(v)))
    assert _rel(out16, ref16) <= 1e-3
    assert _rel(out16, out32) < 1e-2


# ------------------------------------------------------ ranked IDs ---- #
@pytest.mark.parametrize("s,n,r,k,rtol", [(40, 60, 5, 12, 1e-2), (37, 50, 9, 16, 1e-3),
                                         (64, 64, 20, 24, 1e-4)])
def test_ranked_row_ids_match_reference(s, n, r, k, rtol):
    """A rank-r matrix plus noise 1e-6: the detected rank, the live pivots
    and the interpolation matrix equal the reference's (P to 1e-5 of its
    largest entry)."""
    rng = np.random.default_rng(s + n + r)
    m = (rng.normal(size=(n, r)) @ rng.normal(size=(r, s))
         + 1e-6 * rng.normal(size=(n, s))).astype(np.float32)
    jpiv, jp, jrank = jidqr.row_interp_decomp_ranked(jnp.asarray(m), k, rtol)
    tpiv, tp, trank = tidqr.row_interp_decomp_ranked(torch.as_tensor(m), k, rtol)
    assert int(trank) == int(jrank) == r
    np.testing.assert_array_equal(tpiv.numpy()[:r], np.asarray(jpiv)[:r])
    _close(tp, jp)
    assert not tp.numpy()[:, r:].any()


def test_finish_interp_prefix_rank_and_truncated_pivots():
    """Adaptive mode keeps the longest prefix above the tolerance, sets the
    identity on live skeleton columns only and interpolates the truncated
    pivots; fixed mode keeps every skeleton's identity."""
    rng = np.random.default_rng(9)
    m = (rng.normal(size=(30, 4)) @ rng.normal(size=(4, 20))).astype(np.float32)
    piv, qs = tidqr.cpqr_select(torch.as_tensor(m), 8)
    r_full = qs.T @ torch.as_tensor(m)
    t_ad, rank = tidqr.finish_interp(piv, r_full, 1e-3, keep_identity=False)
    t_fx, _ = tidqr.finish_interp(piv, r_full, 1e-3, keep_identity=True)
    jt_ad, jrank = jidqr.finish_interp(jnp.asarray(piv.numpy()), jnp.asarray(r_full.numpy()),
                                       1e-3, keep_identity=False)
    assert int(rank) == int(jrank) == 4
    _close(t_ad, jt_ad)
    assert not t_ad[4:].any()
    np.testing.assert_array_equal(t_fx[:, piv.long()].numpy(), np.eye(8, dtype=np.float32))


# ------------------------------------------------------ end to end ---- #
def _engines(name, h, comp_j, comp_t, x, y, leaf):
    je = JEngine(spec=JSpec(name=name, h=h), comp=comp_j, leaf_size=leaf, max_it=10)
    jm = je.fit(x, y, 1.0)
    te = TEngine(spec=TSpec(name, h), comp=comp_t, leaf_size=leaf,
                 admm=tadmm.ADMMParams(max_it=10), device="cpu")
    tm = te.fit(x, y, 1.0)
    return je, jm, te, tm


def test_laplacian_engine_matches_jax_engine():
    """tests/test_svm.py's laplacian problem (640 points, leaf 64, h = 2) at
    fixed rank: identical predictions, bias to 1e-5 relative."""
    x, y = synthetic.blobs(640 + 128, n_features=4, seed=3, sep=1.8)
    comp = dict(rank=32, n_near=48, n_far=64)
    je, jm, te, tm = _engines("laplacian", 2.0, JParams(**comp), TParams(**comp),
                              x[:640], y[:640], 64)
    xte, yte = x[640:], y[640:]
    assert tm.spec.name == "laplacian"
    np.testing.assert_array_equal(tm.predict(xte).numpy(), np.asarray(jm.predict(xte)))
    jb = float(np.asarray(jm.biases)[0])
    assert abs(float(tm.biases[0]) - jb) <= 1e-5 * max(1.0, abs(jb))
    assert float((tm.predict(xte).numpy() == yte).mean()) > 0.85
    assert te.report.kernel_evals == je.report.kernel_evals


def test_crude_engine_matches_jax_engine():
    """The crude preset end to end with the laplacian kernel on 8-feature
    blobs (the shapes of the slice's chip run, scaled down): ranks before
    and after the shrink identical, identical predictions."""
    xtr, ytr, xte, _ = synthetic.train_test("blobs", 1024, 256, seed=0,
                                            n_features=8, sep=1.6)
    je, jm, te, tm = _engines("laplacian", 2.0, JParams.crude(), TParams.crude(),
                              xtr, ytr, 64)
    rt, rj = te.report, je.report
    assert rt.ranks_pre == rj.ranks_pre and rt.ranks_post == rj.ranks_post
    assert rt.rank_sum_pre == rj.rank_sum_pre and rt.rank_sum_post == rj.rank_sum_post
    assert abs(rt.memory_mb - rj.memory_mb) < 1e-9
    np.testing.assert_array_equal(tm.predict(xte).numpy(), np.asarray(jm.predict(xte)))


def test_truncating_engine_agrees_with_jax_engine():
    """The gaussian kernel at the crude preset on 2-feature circles, where
    the tolerance truncates every level and prepare shrinks the arrays:
    the rank caps before and after the shrink identical.  The upper levels
    of the two builds see different NEAR proxies (the sibling's noise-chosen
    dead slots, ROADMAP queue 3), so their operators differ at the
    compression tolerance and a point that close to the decision boundary
    may be classified either way: the predictions agree on at least 98% of
    the test points, and both keep the accuracy of a good classifier on
    this separable data (≥ 0.97; the JAX engine reads 1.0, the port 0.988)."""
    xtr, ytr, xte, yte = synthetic.train_test("circles", 1024, 256, seed=0,
                                              n_features=2, gap=0.8)
    je, jm, te, tm = _engines("gaussian", 1.5, JParams.crude(), TParams.crude(),
                              xtr, ytr, 64)
    rt, rj = te.report, je.report
    assert rt.ranks_pre == rj.ranks_pre and rt.ranks_post == rj.ranks_post
    assert rt.rank_sum_post < rt.rank_sum_pre
    tp, jp = tm.predict(xte).numpy(), np.asarray(jm.predict(xte))
    assert float((tp == jp).mean()) >= 0.98
    assert float((tp == yte).mean()) >= 0.97 and float((jp == yte).mean()) >= 0.97
