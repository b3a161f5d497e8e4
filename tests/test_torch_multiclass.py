"""The port's SVM trainers (multiclass OVR and OVO on one factorization, and
the binary trainer) against the JAX package, on the CPU.

The same numpy data go through the JAX trainer and engine and the port's;
duals, biases, scores and predictions are compared, ``ovo_vote`` on
planted ties, a JAX-trained OVO model scored by the port through
``repro_torch.convert``, and the golden multiclass pin of
tests/test_golden.py on the port.  Tolerances as in
tests/test_torch_engine.py: duals to 1e-5 of C, biases and scores to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiclass as jmc
from repro.core.compression import CompressionParams as JParams
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch import convert
from repro_torch.core import admm as tadmm
from repro_torch.core import multiclass as tmc
from repro_torch.core.compression import CompressionParams as TParams
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.kernelfn import KernelSpec as TSpec
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

COMP = dict(rank=32, n_near=48, n_far=64)


@pytest.fixture(scope="module")
def data4():
    """tests/test_golden.py's 4-class problem."""
    return synthetic.train_test("multiclass_blobs", 1024, 256, seed=0, n_classes=4, sep=3.0)


@pytest.fixture(scope="module")
def trainers(data4):
    xtr, ytr, _, _ = data4
    jt = jmc.MulticlassHSSSVMTrainer(spec=JSpec(h=1.5), comp=JParams(**COMP),
                                     leaf_size=128, max_it=10)
    jt.prepare(xtr, ytr)
    jm, (jz, _) = jt.train(1.0)
    tt = tmc.MulticlassHSSSVMTrainer(spec=TSpec(h=1.5), comp=TParams(**COMP),
                                     leaf_size=128, max_it=10, device="cpu")
    tt.prepare(xtr, ytr)
    tm, (tz, _) = tt.train(1.0)
    return dict(jt=jt, jm=jm, jz=np.asarray(jz), tt=tt, tm=tm, tz=tz)


@pytest.fixture(scope="module")
def engines(data4):
    """OVR on labels 0..3, OVO on labels {5, 8, 11, 14}: each strategy's
    JAX and port engines, trained at C 0.5 then 1 (warm-started)."""
    xtr, ytr, _, _ = data4
    out = {}
    for strategy, y in (("ovr", ytr), ("ovo", ytr * 3 + 5)):
        je = JEngine(spec=JSpec(h=1.5), comp=JParams(**COMP), leaf_size=128, max_it=10,
                     strategy=strategy)
        je.prepare(xtr, y)
        te = TEngine(spec=TSpec(h=1.5), comp=TParams(**COMP), leaf_size=128,
                     admm=tadmm.ADMMParams(max_it=10), strategy=strategy, device="cpu")
        te.prepare(xtr, y)
        out[strategy] = dict(je=je, te=te, jms=je.train_grid([0.5, 1.0]),
                             tms=te.train_grid([0.5, 1.0]))
    return out


def _same_model(tm, jm, xte, z_atol):
    np.testing.assert_allclose(tm.z_y.numpy(), np.asarray(jm.z_y), rtol=0, atol=z_atol)
    np.testing.assert_allclose(tm.biases.numpy(), np.asarray(jm.biases), rtol=0, atol=1e-4)
    js = np.asarray(jm.decision_function(jnp.asarray(xte)))
    np.testing.assert_allclose(tm.decision_function(xte).numpy(), js, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(js).max()))
    np.testing.assert_array_equal(tm.predict(xte).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(xte))))


def test_trainer_matches_jax_trainer(trainers, data4):
    t = trainers
    np.testing.assert_array_equal(t["tt"].engine.problem_labels.numpy(), np.asarray(t["jt"]._ys))
    np.testing.assert_allclose(t["tz"].numpy(), t["jz"], rtol=0, atol=1e-5)
    _same_model(t["tm"], t["jm"], data4[2], 1e-5)
    assert t["tt"].report.kernel_evals == t["jt"].report.kernel_evals


def test_golden_multiclass_pins_on_the_port(trainers, data4):
    """tests/test_golden.py::test_golden_multiclass_accuracy_and_residual_decay."""
    tt, tm = trainers["tt"], trainers["tm"]
    acc = float((tm.predict(data4[2]).numpy() == data4[3]).mean())
    assert acc >= 0.92, acc
    fac = tt.engine.fac
    _, trace = tadmm.admm_svm_batched(fac.solve_mat, tt.engine.problem_labels,
                                      1.0 * tt.engine.problem_masks, fac.beta, max_it=10)
    primal, dual = trace.primal_res.numpy(), trace.dual_res.numpy()
    assert primal.shape == (10, 4)
    assert np.all(primal[-1] < 0.05), primal[-1]
    assert np.all(dual[-1] < 18.0), dual[-1]
    assert np.all(dual[-1] < dual[0]), (dual[0], dual[-1])


@pytest.mark.parametrize("strategy", ["ovr", "ovo"])
def test_engine_matches_jax_engine(engines, data4, strategy):
    """Each model of the warm-started C grid: duals, biases, scores and
    predictions (original label values); problems, pairs and masks equal."""
    e = engines[strategy]
    je, te = e["je"], e["te"]
    np.testing.assert_array_equal(te.problem_labels.numpy(), np.asarray(je.problem_labels))
    np.testing.assert_array_equal(te.problem_masks.numpy(), np.asarray(je.problem_masks))
    assert te.n_problems == (4 if strategy == "ovr" else 6)
    for tm, jm in zip(e["tms"], e["jms"]):
        assert not tm.binary and tm.strategy == strategy
        if strategy == "ovo":
            np.testing.assert_array_equal(tm.pairs, jm.pairs)
        _same_model(tm, jm, data4[2], 1e-5)
    assert te.report.iters_run == je.report.iters_run == (10,) * te.n_problems
    pred = e["tms"][-1].predict(data4[2]).numpy()
    want = data4[3] if strategy == "ovr" else data4[3] * 3 + 5
    assert set(np.unique(pred)) <= set(np.unique(want))
    assert float((pred == want).mean()) >= 0.92


def test_ovo_vote_on_planted_ties():
    """Cyclic vote ties (each class one win), exact zero scores and repeated
    values: the same class indices as the JAX vote, first maximum winning."""
    rng = np.random.default_rng(0)
    for k in (3, 4, 6):
        pairs = np.array([(a, b) for a in range(k) for b in range(a + 1, k)], np.int32)
        scores = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], size=(512, len(pairs)))
        scores = scores.astype(np.float32)
        want = np.asarray(jmc.ovo_vote(jnp.asarray(scores), pairs, k))
        got = tmc.ovo_vote(torch.as_tensor(scores), pairs, k).numpy()
        np.testing.assert_array_equal(got, want)
    # three classes, one win each: the margin decides; all-equal margins: class 0
    pairs = np.array([(0, 1), (0, 2), (1, 2)], np.int32)
    cyc = np.array([[1.0, -1.0, 1.0], [0.5, -2.0, 0.5], [1.0, -1.0, 1.0]], np.float32)
    want = np.asarray(jmc.ovo_vote(jnp.asarray(cyc), pairs, 3))
    np.testing.assert_array_equal(tmc.ovo_vote(torch.as_tensor(cyc), pairs, 3).numpy(), want)


def test_jax_model_scored_by_the_port(engines, data4):
    """A JAX OVO engine model through convert.engine_model_from_numpy: the
    same scores and predictions."""
    jm = engines["ovo"]["jms"][-1]
    tm = convert.engine_model_from_numpy(
        x_perm=np.asarray(jm.x_perm), z_y=np.asarray(jm.z_y), biases=np.asarray(jm.biases),
        classes=jm.classes, h=jm.spec.h, beta=jm.beta, c_value=jm.c_value,
        strategy=jm.strategy, task=jm.task, pairs=jm.pairs, device="cpu")
    assert tm.binary is False and tm.pairs.shape == (6, 2)
    js = np.asarray(jm.decision_function(jnp.asarray(data4[2])))
    np.testing.assert_allclose(tm.decision_function(data4[2]).numpy(), js, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(js).max()))
    np.testing.assert_array_equal(tm.predict(data4[2]).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(data4[2]))))


def test_grid_search_multiclass_matches_jax():
    xtr, ytr, xva, yva = synthetic.train_test("multiclass_blobs", 512, 128, seed=2,
                                              n_classes=3, sep=2.5)
    kw = dict(leaf_size=128, max_it=10)
    _, jres = jmc.grid_search_multiclass(xtr, ytr, xva, yva, [1.5], [0.5, 2.0],
                                         trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = tmc.grid_search_multiclass(xtr, ytr, xva, yva, [1.5], [0.5, 2.0],
                                         trainer_kwargs=dict(kw, comp=TParams(**COMP),
                                                             device="cpu"))
    assert tres["best_c"] == jres["best_c"]
    for key, cell in jres["results"].items():
        assert tres["results"][key]["accuracy"] == cell["accuracy"]


def test_binary_trainer_and_grid_search_match_jax():
    """HSSSVMTrainer on tests/test_golden.py's binary problem (duals, bias,
    predictions, iterations), and grid_search's table, against the JAX
    package's."""
    from repro.core import svm as jsvm
    from repro_torch.core import svm as tsvm

    xtr, ytr, xte, _ = synthetic.train_test("blobs", 1024, 256, seed=0, sep=1.6)
    jt = jsvm.HSSSVMTrainer(spec=JSpec(h=1.0), comp=JParams(**COMP), leaf_size=128)
    jt.prepare(xtr, ytr)
    jm, _ = jt.train(1.0)
    tt = tsvm.HSSSVMTrainer(spec=TSpec(h=1.0), comp=TParams(**COMP), leaf_size=128,
                            device="cpu")
    tt.prepare(xtr, ytr)
    tm, _ = tt.train(1.0)
    np.testing.assert_allclose(tm.z_y.numpy(), np.asarray(jm.z_y), rtol=0, atol=1e-5)
    assert abs(tm.bias - jm.bias) <= 1e-4
    np.testing.assert_array_equal(tm.predict(xte).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(xte))))
    assert tt.report.iters_run == jt.report.iters_run == (10,)
    xtr, ytr, xva, yva = synthetic.train_test("blobs", 512, 128, seed=1, sep=1.6)
    kw = dict(leaf_size=128)
    _, jres = jsvm.grid_search(xtr, ytr, xva, yva, [1.0], [0.5, 2.0],
                               trainer_kwargs=dict(kw, comp=JParams(**COMP)))
    _, tres = tsvm.grid_search(xtr, ytr, xva, yva, [1.0], [0.5, 2.0],
                               trainer_kwargs=dict(kw, comp=TParams(**COMP), device="cpu"))
    assert tres["best_c"] == jres["best_c"]
    for key, cell in jres["results"].items():
        assert tres["results"][key]["accuracy"] == cell["accuracy"]
