"""``HSSSVMEngine(mesh=...)`` over gloo ranks on the CPU against the JAX
package's local engine: the binary SVM, its warm-started C grid, Lanczos,
scoring and serving, the fallback, the launchers.

The same numpy data go through the JAX local ``HSSSVMEngine`` and the
port's engine on 2 and 4 ranks (``dist.api.spawn``; each rank is given the
whole data, builds and trains its own nodes and rows, and scores through
one all-reduce of partial scores).  The reference's docstrings pin its
sharded engine to its local one to 1e-5, so the local engine is the
reference.  At the tolerances of the port's local tests:

  * the warm-started C grid (0.5, 1): the concatenated duals to 1e-4 of C,
    biases to 1e-4, scores to 1e-4 of the largest, the same predictions
    and iteration counts;
  * ``top_eigenpairs`` from the JAX package's seed-0 v0: eigenvalues 1e-4,
    vectors 1e-3 up to sign; ``spectral_embed`` in input order to 5e-3;
  * the psum scorer against the gathered model's local scorer, the serving
    tier and a registry round trip of a mesh model (1e-5);
  * ``train_multilevel`` (coarse 1/4) and an adaptive-ρ run against the
    port's own local engine (which tests/test_torch_multilevel.py holds
    against the JAX package): duals to 1e-4, the same iteration counts,
    final β and rescale count;
  * 3 ranks (not a power of two) run the local path on every rank, and
    ``FitReport.mesh_ranks`` shows it;
  * ``--svm-mesh`` of both launchers at one rank.

1024 blobs points at leaf 128: 8 leaves, 3 levels, at least log2 P for P ≤
4, so ``pad_dataset``'s ``min_levels`` changes nothing and both engines
build the same tree.  The ranks run while this process builds the JAX
references.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch.core.admm import ADMMParams as TADMMParams
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from repro_torch.dist import api as dist_api
from repro_torch.launch import serve as tserve, train as ttrain
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with ranks.torch_threads(1):
        yield


N_PAD, KNOBS = 1024, [0.5, 1.0]
KW = dict(comp=dict(rank=32, n_near=48, n_far=64), leaf_size=128, h=1.0, max_it=10)
ADAPTIVE = dict(max_it=40, tol=1e-3, adapt_rho=True, rho_every=5, rho_max_updates=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks at 2, 4 and 3 (the fallback), started at once; meanwhile
    the JAX local engine on the same data."""
    xtr, ytr, xte, _ = synthetic.train_test("blobs", 1024, 256, seed=0)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N_PAD,), jnp.float32))
    case = [("binary", KW, (xtr, ytr), KNOBS, dict(v0=v0, adaptive=ADAPTIVE))]
    joins = {size: ranks.in_background(
        dist_api.spawn, ranks.engine_cases, size, case, {"binary": xte},
        str(tmp_path_factory.mktemp(f"world{size}"))) for size in (2, 4, 3)}
    kw = dict(KW)
    je = JEngine(spec=JSpec(h=kw.pop("h")), comp=JParams(**kw.pop("comp")), **kw)
    je.prepare(xtr, ytr)
    models = je.train_grid(KNOBS)
    ref = dict(engine=je, z_y=[np.asarray(m.z_y) for m in models],
               biases=[np.asarray(m.biases) for m in models],
               scores=[np.asarray(m.decision_function(jnp.asarray(xte))) for m in models],
               preds=[np.asarray(m.predict(jnp.asarray(xte))) for m in models],
               eig=[np.asarray(a) for a in je.top_eigenpairs(4)], embed=je.spectral_embed(3))
    # the port's local engine: the multilevel warm start and adaptive ρ
    te = TEngine(spec=TSpec(h=KW["h"]), comp=TParams(**KW["comp"]), leaf_size=KW["leaf_size"],
                 admm=TADMMParams(max_it=KW["max_it"]), device="cpu")
    te.prepare(xtr, ytr)
    ml, info = te.train_multilevel(1.0, coarse_frac=0.25)
    ref["multilevel"] = dict(z_y=ml.z_y, iters=info["iters_run"],
                             coarse_iters=info["coarse_iters_run"])
    te.admm = TADMMParams(**ADAPTIVE)
    m, _ = te.train(1.0)
    ref["adaptive"] = dict(z_y=m.z_y, iters=te.report.iters_run,
                           rho=(te.report.rho_final, te.report.rho_rescales))
    return ref, {size: [o["binary"] for o in join()] for size, join in joins.items()}


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_c_grid_matches_the_jax_local_engine(runs, size):
    ref, outs = runs
    res = outs[size]
    assert all(r["mesh_ranks"] == size for r in res)
    # each rank holds n_leaf / P leaves (its e_leaf is a 1/P share)
    assert all(r["e_leaf"][0] == 8 // size and r["n_rows"] == N_PAD // size for r in res)
    for i in range(len(KNOBS)):
        _close(torch.cat([r["z_y"][i] for r in res]).numpy(), ref["z_y"][i], 1e-4,
               scale=KNOBS[i])
        for r in res:                      # every rank gets the whole scores
            _close(r["biases"][i], ref["biases"][i], 1e-4, scale=1.0)
            _close(r["scores"][i], ref["scores"][i], 1e-4)
            np.testing.assert_array_equal(r["preds"][i].numpy(), ref["preds"][i])
    assert res[0]["iters"] == ref["engine"].report.iters_run


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_eigenpairs_scorer_and_serving(runs, size):
    """top_eigenpairs / spectral_embed from the same v0; the psum scorer
    against the gathered model's local scorer, the serving tier and a
    registry round trip; the run's traffic."""
    ref, outs = runs
    res = outs[size]
    _close(res[0]["eig"][0].numpy(), ref["eig"][0], 1e-4)
    vecs = torch.cat([r["eig"][1] for r in res]).numpy()
    sign = np.sign((vecs * ref["eig"][1]).sum(0))
    assert np.abs(vecs * sign - ref["eig"][1]).max() <= 1e-3
    emb = res[0]["embed"]
    sign = np.sign((emb * ref["embed"]).sum(0))
    assert np.abs(emb * sign - ref["embed"]).max() <= 5e-3 * np.abs(ref["embed"]).max()
    assert all(r["rho_floor"] == res[0]["rho_floor"] >= 0.0 for r in res)
    for r in res:
        psum = r["scores"][-1].numpy()
        assert r["whole_rows"] == N_PAD
        for other in ("local_scores", "served", "registry_scores"):
            _close(np.asarray(r[other]).reshape(psum.shape), psum, 1e-5)
        assert r["stats"]["all_gather_calls"] > 0 and r["stats"]["all_reduce_calls"] > 0


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_multilevel_and_adaptive_rho_match_the_local_port(runs, size):
    """The coarse problem trained locally on every rank, its duals prolonged
    on the host and cut to each rank's rows; adaptive ρ refactorizing the
    node-split K̃ once per visited β."""
    ref, outs = runs
    res = outs[size]
    for key in ("multilevel", "adaptive"):
        z = torch.cat([r[key]["z_y"] for r in res]).numpy()
        _close(z, ref[key]["z_y"].numpy(), 1e-4, scale=1.0)
        assert all(r[key]["iters"] == ref[key]["iters"] for r in res)
    assert all(r["multilevel"]["coarse_iters"] == ref["multilevel"]["coarse_iters"]
               for r in res)
    assert all(r["adaptive"]["rho"] == ref["adaptive"]["rho"] for r in res)


@pytest.mark.parametrize("size", [2, 4, 3])
def test_mesh_streamed_engine_matches_the_resident_one(runs, size):
    """``HSSSVMEngine(mesh=, stream=)``: each rank streams its own nodes'
    batches (3 ranks: the local streamed build on every rank); after the
    same warm-started grid the duals equal the resident mesh engine's to
    1e-4 of C and the predictions (so the accuracy) the JAX local engine's."""
    ref, outs = runs
    res = outs[size]
    for r in res:
        s = r["streamed"]
        assert s["mesh_ranks"] == r["mesh_ranks"] and s["batches"] > 0
        _close(s["z_y"].numpy(), r["z_y"][-1].numpy(), 1e-4, scale=KNOBS[-1])
        np.testing.assert_array_equal(s["preds"].numpy(), ref["preds"][-1])


def test_three_ranks_fall_back_to_the_local_path(runs):
    """A rank count that is not a power of two: every rank runs the local
    engine (mesh_ranks 1, all 1024 rows), with the local engine's numbers."""
    ref, outs = runs
    for r in outs[3]:
        assert r["mesh_ranks"] == 1 and r["n_rows"] == N_PAD and r["e_leaf"][0] == 8
        _close(r["z_y"][-1].numpy(), ref["z_y"][-1], 1e-4)
        np.testing.assert_array_equal(r["preds"][-1].numpy(), ref["preds"][-1])
        assert r["stats"]["all_gather_calls"] == 0


def test_svm_mesh_launchers_at_one_rank(capsys):
    """``--svm-mesh`` without torchrun: a one-rank gloo mesh through each
    launcher, the mesh named in the output, the group torn down after."""
    out = ttrain.main(["--task", "svm", "--svm-mesh", "--device", "cpu", "--svm-train", "1024",
                       "--svm-test", "256", "--svm-c-grid", "1", "--svm-leaf", "128"])
    assert out["mesh_ranks"] == 1 and out["grid"][0]["accuracy"] > 0.9
    res = tserve.main(["--task", "svm", "--svm-mesh", "--device", "cpu", "--svm-train", "1024",
                       "--requests", "2", "--batch", "8"])
    assert res["mesh_ranks"] == 1 and res["accuracy"] > 0.8
    text = capsys.readouterr().out
    assert text.count("mesh ('data',) of 1 ranks, backend gloo: all_gather and all_reduce "
                      "on cpu tensors") == 2
    assert not torch.distributed.is_initialized()
