"""The port's node-split HSS build, factorization and solve over gloo ranks
against the JAX package on the CPU.

The same numpy points as tests/test_torch_dist.py (512 blobs points at leaf
32: 16 leaves, 4 levels) go through the JAX package's ``compress``,
``shrink_to_fit``, ``factorize`` and ``hss_solve_mat`` in this process and
through ``compress_sharded`` and the split factorization and solve on 2 and
4 gloo ranks (``dist.api.spawn``, started first so that they run while JAX
compiles).  Concatenated over the ranks, fixed and adaptive rank: the
skeleton ids of every level equal the JAX package's, the leaf arrays, the
leaf factors, the root LU and the solve agree to 1e-5 of each array's
largest entry (the two packages' f32 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.core import compression as jcomp
from repro.core import factorization as jfac
from repro.core import hss as jhss
from repro.core import tree as jtree
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch.core import tree as ttree
from repro_torch.dist import api as dist_api
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with ranks.torch_threads(1):
        yield


N, LEAF, BETA, N_RHS = 512, 32, 100.0, 3
COMPS = [dict(rank=16, n_near=16, n_far=16), dict(rank=16, n_near=16, n_far=16, rtol=1e-2)]
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs():
    x, y = synthetic.blobs(N, n_features=8, sep=1.6, seed=3)
    x_pad, _, _, levels = jtree.pad_dataset(x, y, LEAF)
    tree = ttree.build_tree(x_pad, LEAF, levels)
    xp = x_pad[tree.perm]
    rhs = np.random.default_rng(0).standard_normal((xp.shape[0], N_RHS)).astype(np.float32)
    joins = {size: ranks.in_background(dist_api.spawn, ranks.split_stack, size, xp, tree,
                                       COMPS, BETA, rhs) for size in WORLDS}
    jt = jtree.build_tree(x_pad, LEAF, levels)
    refs = []
    for kw in COMPS:
        jh = jhss.shrink_to_fit(jcomp.compress(jnp.asarray(xp), jt, JSpec(h=1.0),
                                               jcomp.CompressionParams(**kw)))
        jf = jfac.factorize(jh, BETA)
        refs.append(dict(hss=jh, fac=jf,
                         solve=np.asarray(jfac.hss_solve_mat(jf, jnp.asarray(rhs)))))
    return refs, {size: join() for size, join in joins.items()}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1e-30, float(np.abs(want).max())))


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("case", [0, 1], ids=["fixed", "adaptive"])
def test_split_build_matches_the_jax_package(runs, case, size):
    refs, outs = runs
    jref = refs[case]
    res = [o[case] for o in outs[size]]
    cut = res[0]["cut"]
    np.testing.assert_array_equal(torch.cat([r["hss"]["skel_leaf"] for r in res]).numpy(),
                                  np.asarray(jref["hss"].skel_leaf))
    for k, js in enumerate(jref["hss"].skels, 1):        # split below the cut
        got = (torch.cat([r["hss"]["skels"][k - 1] for r in res]) if k < cut
               else res[0]["hss"]["skels"][k - 1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(js))
    for name in ("d_leaf", "u_leaf"):
        _close(torch.cat([r["hss"][name] for r in res]), getattr(jref["hss"], name), 1e-5)
    for name in ("e_leaf", "g_leaf"):
        _close(torch.cat([r["fac"][name] for r in res]), getattr(jref["fac"], name), 1e-5)
    _close(res[0]["fac"]["root_lu"], jref["fac"].root_lu, 1e-5)
    _close(torch.cat([r["solve"] for r in res]), jref["solve"], 1e-5)
