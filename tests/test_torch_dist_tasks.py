"""``HSSSVMEngine(mesh=...)`` over gloo ranks on the CPU against the JAX
package's local engine: the tasks beyond the binary SVM.

As tests/test_torch_dist_engine.py, for multiclass OVO (6 pair problems,
labels {5, 8, 11, 14}), ε-SVR (β 10, 30 iterations), ν one-class (30
iterations) and GP (λ 0.5, the log marginal with the JAX package's seed-0
Rademacher probes), at 2 and 4 ranks: the concatenated duals (or GP
coefficients) to 1e-4 of the box (of the largest coefficient), biases to
1e-4, scores to 1e-4 of the largest on every rank, the same predictions for
the classifiers, the same iteration counts, the log marginal to 1e-4
relative.  Every case is 1024 points of 8 features at leaf 128 (the JAX
package then compiles its build once for all four).  The ranks run while
this process builds the JAX references.
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
from repro_torch.dist import api as dist_api
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with ranks.torch_threads(1):
        yield


N_PAD, F = 1024, 8
BASE = dict(comp=dict(rank=32, n_near=48, n_far=64), leaf_size=128)


def _cases():
    """(name, engine kwargs, prepare args, knobs, test points)."""
    multi = synthetic.train_test("multiclass_blobs", 1024, 256, seed=0, n_classes=4, sep=3.0,
                                 n_features=F)
    sine = synthetic.train_test("noisy_sine", 1024, 256, seed=0, noise=0.1, n_features=F)
    oc_x, _ = synthetic.blobs_with_outliers(1024, n_features=F, outlier_frac=0.1, seed=0)
    oc_te, _ = synthetic.blobs_with_outliers(256, n_features=F, outlier_frac=0.1, seed=1)
    return [
        ("ovo", dict(BASE, h=1.5, max_it=10, strategy="ovo"), (multi[0], multi[1] * 3 + 5),
         [1.0], multi[2]),
        ("svr", dict(BASE, h=1.0, max_it=30, task="svr", svr_c=2.0, beta=10.0),
         (sine[0], sine[1]), [0.1], sine[2]),
        ("oneclass", dict(BASE, h=2.0, max_it=30, task="oneclass"), (oc_x,), [0.1], oc_te),
        ("gp", dict(BASE, h=1.0, max_it=10, task="gp"), (sine[0], sine[1]), [0.5], sine[2]),
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    probes = np.stack([np.asarray(jax.random.rademacher(k, (N_PAD,), jnp.float32))
                       for k in keys])
    cases = _cases()
    jobs = [(name, kw, prep, knobs, dict(probes=probes)) for name, kw, prep, knobs, _ in cases]
    xte = {name: x for name, _, _, _, x in cases}
    joins = {size: ranks.in_background(
        dist_api.spawn, ranks.engine_cases, size, jobs, xte,
        str(tmp_path_factory.mktemp(f"world{size}"))) for size in (2, 4)}
    refs = {}
    for name, kw, prep, knobs, x in cases:
        kw = dict(kw)
        je = JEngine(spec=JSpec(h=kw.pop("h")), comp=JParams(**kw.pop("comp")), **kw)
        je.prepare(*prep)
        m = je.train_grid(knobs)[-1]
        refs[name] = dict(engine=je, z_y=np.asarray(m.z_y), biases=np.asarray(m.biases),
                          scores=np.asarray(m.decision_function(jnp.asarray(x))),
                          preds=np.asarray(m.predict(jnp.asarray(x))))
        if name == "gp":
            refs[name]["log_marginal"] = je.log_marginal(knobs[0], n_probes=4, num_iters=20,
                                                         seed=0)
    return refs, {size: join() for size, join in joins.items()}


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", ["ovo", "svr", "oneclass", "gp"])
def test_mesh_task_matches_the_jax_local_engine(runs, name, size):
    refs, outs = runs
    ref = refs[name]
    res = [o[name] for o in outs[size]]
    assert all(r["mesh_ranks"] == size and r["e_leaf"][0] == 8 // size for r in res)
    box = {"ovo": 1.0, "svr": 2.0, "gp": None,
           "oneclass": 1.0 / (0.1 * float(np.asarray(ref["engine"].problem_masks).sum()))}[name]
    z = torch.cat([r["z_y"][-1] for r in res]).numpy()
    _close(z, ref["z_y"], 1e-4, scale=box)
    for r in res:                          # every rank gets the whole scores
        _close(r["biases"][-1], ref["biases"], 1e-4, scale=1.0)
        _close(r["scores"][-1], ref["scores"], 1e-4)
        if name in ("ovo", "oneclass"):
            np.testing.assert_array_equal(r["preds"][-1].numpy(), ref["preds"])
    assert res[0]["iters"] == ref["engine"].report.iters_run
    if name == "gp":
        want = ref["log_marginal"]
        assert all(abs(r["log_marginal"] - want) <= 1e-4 * abs(want) for r in res)
