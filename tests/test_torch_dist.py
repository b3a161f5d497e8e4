"""The port's node-split HSS stack over gloo ranks on the CPU.

``repro_torch.dist.api.spawn`` starts 2 or 4 ranks (a FileStore in a fresh
temporary directory, no port); each runs ``tests/torch_dist_ranks.py`` on
the same numpy inputs and returns its part.  Concatenated over the ranks:

  * against the port's local ``compress`` / ``factorize`` /
    ``hss_solve_mat`` / ``matmat``: skeleton ids equal, every array within
    1e-6 of its largest entry (the same decompositions of the same blocks,
    only the batch axis cut), fixed and adaptive rank;
  * the transition rule: the same build at cut 1 (everything above the
    leaves replicated) gives the same numbers;
  * the fallback: a leaf count the rank count does not divide builds the
    local matrix;
  * the two collectives on rank-dependent blocks, float and int;
  * the C-grid functions of ``core/distributed.py`` (binary, on the split and
    on the whole factorization, and multiclass with a participation mask),
    warm-started over C 0.5, 1: z against ``admm_svm`` /
    ``admm_svm_batched`` on the local factorization to 1e-5 of the
    largest |z|.

tests/test_torch_dist_jax.py holds the split build against the JAX
package.  512 blobs points at leaf 32 (16 leaves, 4 levels): at 4 ranks
levels 0-1 are split, at 2 ranks levels 0-2.  The first rank of 2 also
builds the local references.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.core import compression, tree as ttree
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.data import synthetic
from repro_torch.dist import api as dist_api
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with ranks.torch_threads(1):
        yield


N, LEAF, BETA, N_RHS = 512, 32, 100.0, 3
GRID_CS = (0.5, 1.0)
COMPS = [dict(rank=16, n_near=16, n_far=16), dict(rank=16, n_near=16, n_far=16, rtol=1e-2)]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1e-30, float(np.abs(want).max())))


WORLDS = (2, 4)


@pytest.fixture(scope="module")
def problem():
    """The inputs and the ranks' results at 2 and 4 ranks (both spawned
    at once)."""
    x, y = synthetic.blobs(N, n_features=8, sep=1.6, seed=3)
    x_pad, _, _, levels = ttree.pad_dataset(x, y, LEAF)
    tree = ttree.build_tree(x_pad, LEAF, levels)
    xp = x_pad[tree.perm]
    rhs = np.random.default_rng(0).standard_normal((xp.shape[0], N_RHS)).astype(np.float32)
    xs, _ = synthetic.blobs(2 * LEAF, n_features=8, seed=4)    # 2 leaves
    small = (xs[ttree.build_tree(xs, LEAF, 1).perm], ttree.build_tree(xs, LEAF, 1))
    rng = np.random.default_rng(1)
    y = np.where(rng.random(xp.shape[0]) < 0.5, -1.0, 1.0).astype(np.float32)
    ys = np.where(rng.random((3, xp.shape[0])) < 0.5, -1.0, 1.0).astype(np.float32)
    pmask = (rng.random((3, xp.shape[0])) < 0.8).astype(np.float32)
    grid = (y, ys, pmask, GRID_CS)
    joins = {size: ranks.in_background(dist_api.spawn, ranks.hss_stack, size, xp, tree,
                                       COMPS, BETA, rhs, small, grid)
             for size in WORLDS}
    outs = {size: join() for size, join in joins.items()}
    return dict(small=small, outs=outs, **outs[WORLDS[0]][0]["reference"])


@pytest.fixture(scope="module", params=WORLDS)
def world(request, problem):
    """The stack's per-rank results at 2 and at 4 ranks."""
    return request.param, problem["outs"][request.param]


def _whole(parts, k, cut):
    """A level-k array from the ranks' parts: concatenated below the cut,
    rank 0's (all equal) above it."""
    if k < cut:
        return torch.cat(parts)
    for q in parts[1:]:
        assert torch.equal(q, parts[0])
    return parts[0]


def _levels(res, kind, name):
    """(level, [per-rank arrays]) of one field: a leaf array or a per-level
    tuple (level k = index + 1)."""
    if name in res[0][kind] and not isinstance(res[0][kind][name], list):
        yield 0, [r[kind][name] for r in res]
        return
    for i in range(len(res[0][kind].get(name, []))):
        yield i + 1, [r[kind][name][i] for r in res]


FIELDS = dict(hss=("d_leaf", "u_leaf", "skel_leaf", "leaf_ranks", "transfers", "skels",
                   "b_mats", "level_ranks"),
              fac=("e_leaf", "g_leaf", "e_lvls", "g_lvls", "root_lu", "root_piv"))


@pytest.mark.parametrize("case", [0, 1], ids=["fixed", "adaptive"])
def test_split_build_factorization_and_solve_match_the_local_ones(problem, world, case):
    """Rule cut and cut 1 alike: every level's arrays concatenated over the
    ranks equal the local build's (ids exactly, the rest to 1e-6 of each
    array's largest entry), and so do the solve and the matmat."""
    p_, outs = world
    loc = problem["local"][case]
    want_cut = dist_api.shard_levels(_Mesh(p_), loc["hss"].levels)
    for tag in ("rule", "cut1"):
        res = [o["cases"][case][tag] for o in outs]
        cut = res[0]["cut"]
        assert cut == (want_cut if tag == "rule" else 1)
        assert res[0]["info"]["ranks_post"] == tuple(loc["hss"].ranks)
        n_leaf = loc["hss"].n_leaves
        assert [r["node_range"] for r in res] == [
            (q * n_leaf // p_, (q + 1) * n_leaf // p_) for q in range(p_)]
        for kind, obj in (("hss", loc["hss"]), ("fac", loc["fac"])):
            for name in FIELDS[kind]:
                ref = getattr(obj, name)
                refs = [ref] if isinstance(ref, torch.Tensor) else list(ref or ())
                for k, parts in _levels(res, kind, name):
                    if name.startswith("root"):
                        k = cut          # replicated
                    got = _whole(parts, k, cut)
                    want = refs[0] if k == 0 or name.startswith("root") else refs[k - 1]
                    if got.dtype in (torch.int32, torch.int64):
                        assert torch.equal(got, want), (tag, name, k)
                    else:
                        _close(got, want, 1e-6)
        _close(torch.cat([r["solve"] for r in res]), loc["solve"], 1e-6)
        _close(torch.cat([r["matmat"] for r in res]), loc["matmat"], 1e-6)
    # the whole local build cut to each rank's nodes factorizes the same
    from_whole = torch.cat([o["cases"][case]["from_whole"]["solve"] for o in outs])
    _close(from_whole, loc["solve"], 1e-6)


@pytest.mark.parametrize("case", [0, 1], ids=["fixed", "adaptive"])
def test_streamed_build_on_the_mesh_equals_the_split_build(world, case):
    """``compress_streamed(mesh=)`` at 3 nodes a batch: on every rank, every
    array equal to ``compress_sharded``'s (skeleton ids and ranks exactly,
    the rest to 1e-6 of each array's largest entry), at the same cut; a
    failure at the cut level restarts from the rank's own checkpoint
    directory and gives the same arrays bit for bit."""
    p_, outs = world
    for r, o in enumerate(outs):
        s = o["cases"][case]["streamed"]
        assert s["cut"] == s["sharded_cut"] > 0
        assert set(s["hss"]) == set(s["sharded"])
        for name, want in s["sharded"].items():
            got = s["hss"][name]
            for g, w in zip(got if isinstance(got, list) else [got],
                            want if isinstance(want, list) else [want]):
                if w.dtype in (torch.int32, torch.int64):
                    assert torch.equal(g, w), name
                else:
                    _close(g, w, 1e-6)
            for g, w in zip(s["resumed"][name] if isinstance(got, list) else [s["resumed"][name]],
                            got if isinstance(got, list) else [got]):
                assert torch.equal(g, w), name
        assert s["restarts"] == 1 and s["resumed_level"] == s["cut"]
        assert s["ckpt_dirs"] == [f"rank{r}_of_{p_}"]


def test_fallback_and_traffic(problem, world):
    """2 leaves over 2 or 4 ranks: the local build on every rank.  The
    split build gathered once at the cut (skeleton points, ids, ranks) and
    the deficit-row exchange of the near proxies."""
    p_, outs = world
    ref = compression.compress(problem["small"][0], problem["small"][1], KernelSpec(h=1.0),
                               compression.CompressionParams(**COMPS[0]), device="cpu")
    for o in outs:
        if p_ > 2:
            assert o["fallback_mesh"]
            assert torch.equal(o["fallback"]["skel_leaf"], ref.skel_leaf)
        assert o["stats"]["all_gather_calls"] > 0 and o["stats"]["all_reduce_calls"] > 0


def test_collectives(world):
    """all_gather in rank order, all_reduce sum and max, on every rank."""
    p_, outs = world
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
                      for r in range(p_)])
    for o in outs:
        c = o["collectives"]
        assert torch.equal(c["gather"], want)
        assert torch.equal(c["gather_int"], torch.arange(p_, dtype=torch.int32
                                                         ).repeat_interleave(3)[:, None]
                           .expand(-1, 2))
        assert torch.equal(c["sum"], torch.tensor([float(p_), float(sum(range(p_)))]))
        assert torch.equal(c["max"], torch.tensor([p_ - 1, 0], dtype=torch.int32))
        assert c["describe"] == (f"mesh ('data',) of {p_} ranks, backend gloo: all_gather "
                                 "and all_reduce on cpu tensors")
        assert c["stats"]["all_gather_calls"] == 2 and c["stats"]["all_reduce_calls"] == 2


class _Mesh:
    """Stands in for a mesh of ``size`` ranks where only the size is read."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("p,levels,cut", [(1, 12, 12), (2, 5, 4), (4, 5, 3), (8, 5, 2),
                                          (32, 5, 1), (4, 2, 1), (64, 5, 0), (3, 5, 0)])
def test_transition_rule(p, levels, cut):
    """Split while n_k / P is even (the leaves whenever P divides them)."""
    assert dist_api.shard_levels(_Mesh(p), levels) == cut
    assert dist_api.shard_levels(None, levels) == 0


def test_c_grid_functions_match_the_local_admm(problem, world):
    """admm_train_distributed on the split factorization and on the whole
    one (cut to each rank's nodes), admm_train_multiclass_distributed with
    a participation mask: the ranks' z rows concatenated equal the local
    warm-started ADMM's to 1e-5 of the largest |z|."""
    _, outs = world
    grid = [o["cases"][0]["grid"] for o in outs]
    for i, c in enumerate(GRID_CS):
        for key in ("binary", "binary_whole"):
            _close(torch.cat([g[key][i] for g in grid]), problem["grid"]["binary"][i], 1e-5)
        _close(torch.cat([g["multi"][i] for g in grid]), problem["grid"]["multi"][i], 1e-5)
