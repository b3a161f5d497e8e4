"""The port's model registry, and artifacts moving between the two packages.

tests/test_registry.py's cases on ``repro_torch.serve``: bit-exact round
trips per task shape, versions, a missing model, bad names, foreign / stale
/ tampered / partial artifacts refused, and both pruning cases.  Then a
model saved by the JAX package's registry loads in the port and scores
within 1e-5 of the largest |score|, and the reverse.  The fixtures live
here.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineModel as JModel
from repro.core.kernelfn import KernelSpec as JSpec
from repro.serve import ModelRegistry as JRegistry, model_fingerprint as jfingerprint
from repro_torch import ckpt
from repro_torch.core.engine import EngineModel
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.serve import (FORMAT_VERSION, ModelRegistry, RegistryError,
                               model_fingerprint)
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

TASKS = ("binary", "ovr", "ovo", "svr", "oneclass")


def _arrays(task, d=96, f=4, seed=0):
    """A synthetic model's arrays of the given task shape (no training)."""
    r = np.random.default_rng(seed)
    n_prob = 3 if task in ("ovr", "ovo") else 1
    return dict(
        x=r.normal(size=(d, f)).astype(np.float32),
        zy=(0.3 * r.normal(size=(d, n_prob))).astype(np.float32),
        biases=(0.1 * r.normal(size=n_prob)).astype(np.float32),
        classes=(np.arange(3.0, dtype=np.float32) if n_prob == 3
                 else np.array([-1.0, 1.0], np.float32)),
        pairs=np.array([[0, 1], [0, 2], [1, 2]], np.int32) if task == "ovo" else None,
        binary=task == "binary", strategy="ovo" if task == "ovo" else "ovr",
        task=task if task in ("svr", "oneclass") else "svm")


def mk_model(task="binary", seed=0, h=1.3, beta=64.0):
    a = _arrays(task, seed=seed)
    return EngineModel(
        x_perm=torch.as_tensor(a["x"]), z_y=torch.as_tensor(a["zy"]),
        biases=torch.as_tensor(a["biases"]), classes=a["classes"], spec=KernelSpec(h=h),
        c_value=1.0, binary=a["binary"], strategy=a["strategy"], task=a["task"],
        pairs=a["pairs"], beta=beta)


def mk_jax_model(task="binary", seed=0, h=1.3, beta=64.0):
    a = _arrays(task, seed=seed)
    return JModel(
        x_perm=jnp.asarray(a["x"]), z_y=jnp.asarray(a["zy"]), biases=jnp.asarray(a["biases"]),
        classes=a["classes"], spec=JSpec(h=h), c_value=1.0, binary=a["binary"],
        strategy=a["strategy"], task=a["task"], pairs=a["pairs"], beta=beta)


@pytest.fixture()
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "models"))


def _assert_models_equal(a, b):
    for name in ("x_perm", "z_y", "biases"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), name
    assert np.array_equal(np.asarray(a.classes), np.asarray(b.classes))
    if a.pairs is None:
        assert b.pairs is None
    else:
        assert np.array_equal(np.asarray(a.pairs), np.asarray(b.pairs))
    assert (a.task, a.strategy, a.binary) == (b.task, b.strategy, b.binary)
    assert (a.spec.name, a.spec.h) == (b.spec.name, b.spec.h)
    assert a.c_value == b.c_value and a.beta == b.beta


def _queries(model, n=20, seed=2):
    return np.random.default_rng(seed).normal(size=(n, model.x_perm.shape[1])).astype(np.float32)


@pytest.mark.parametrize("task", TASKS)
def test_round_trip_bit_identical(registry, task):
    model = mk_model(task, seed=13)
    version = registry.save(task, model)
    loaded, info = registry.load(task, device="cpu")
    assert version == 1 and info.version == 1
    assert info.n_support_kept == info.n_support_stored
    _assert_models_equal(model, loaded)
    xq = _queries(model)
    assert torch.equal(model.predict(xq), loaded.predict(xq))


def test_versions_accumulate_and_load_by_version(registry):
    m1, m2 = mk_model("binary", seed=1), mk_model("binary", seed=2)
    assert registry.save("m", m1) == 1
    assert registry.save("m", m2) == 2
    assert registry.versions("m") == [1, 2] and registry.names() == ["m"]
    latest, info = registry.load("m", device="cpu")
    _assert_models_equal(m2, latest)
    v1, info1 = registry.load("m", version=1, device="cpu")
    _assert_models_equal(m1, v1)
    assert info.version == 2 and info1.version == 1


def test_missing_model_raises(registry):
    with pytest.raises(RegistryError, match="no such model"):
        registry.load("nope", device="cpu")
    with pytest.raises(RegistryError, match="no such model"):
        registry.load("nope", version=3, device="cpu")
    assert registry.versions("nope") == []


def test_bad_names_rejected(registry):
    for name in ("", ".hidden", f"a{os.sep}b"):
        with pytest.raises(RegistryError, match="bad model name"):
            registry.save(name, mk_model("binary"))


def test_foreign_artifact_rejected(registry):
    ckpt.save_checkpoint(registry._dir("foreign"), dict(z=np.zeros((4, 1), np.float32)),
                         step=1, extra=dict(stream_fingerprint={"kind": "hss_stream_build"}))
    with pytest.raises(RegistryError, match="foreign artifact"):
        registry.load("foreign", device="cpu")


def _raw_tree(model):
    return dict(x_perm=model.x_perm.numpy(), z_y=model.z_y.numpy(),
                biases=model.biases.numpy(), classes=np.asarray(model.classes))


def test_stale_format_version_rejected(registry):
    model = mk_model("binary", seed=3)
    fp = dict(model_fingerprint(model), format_version=FORMAT_VERSION + 1)
    ckpt.save_checkpoint(registry._dir("stale"), _raw_tree(model), step=1,
                         extra=dict(fingerprint=fp))
    with pytest.raises(RegistryError, match="stale artifact format"):
        registry.load("stale", device="cpu")


def test_tampered_shape_fingerprint_rejected(registry):
    model = mk_model("binary", seed=4)
    fp = model_fingerprint(model)
    fp["n_support"] += 1
    ckpt.save_checkpoint(registry._dir("bad"), _raw_tree(model), step=1,
                         extra=dict(fingerprint=fp))
    with pytest.raises(RegistryError, match="fingerprint/n_support"):
        registry.load("bad", device="cpu")


def test_missing_array_rejected(registry):
    model = mk_model("binary", seed=5)
    ckpt.save_checkpoint(registry._dir("partial"), dict(x_perm=model.x_perm.numpy()),
                         step=1, extra=dict(fingerprint=model_fingerprint(model)))
    with pytest.raises(RegistryError, match="missing"):
        registry.load("partial", device="cpu")


def test_prune_drops_zero_weight_rows_exactly(registry):
    model = mk_model("binary", seed=6)
    zy = model.z_y.clone()
    zy[::3] = 0.0                       # every third row carries no weight
    model = dataclasses.replace(model, z_y=zy)
    registry.save("z", model)
    loaded, info = registry.load("z", prune_tol=0.0, device="cpu")
    keep = zy[:, 0].abs() > 0
    assert info.n_support_kept == int(keep.sum()) and info.pruned_frac > 0.3
    assert torch.equal(loaded.x_perm, model.x_perm[keep])
    assert torch.equal(loaded.z_y, zy[keep])


def test_prune_degenerate_keeps_top_sv(registry):
    model = mk_model("binary", seed=7)
    registry.save("d", model)
    loaded, info = registry.load("d", prune_tol=1e9, device="cpu")   # prunes everything
    assert info.n_support_kept == 1
    top = int(model.z_y[:, 0].abs().argmax())
    assert torch.equal(loaded.x_perm, model.x_perm[top][None])


# --------------------------------------------------------------------- #
# across the two packages                                                #
# --------------------------------------------------------------------- #
def _close(port_scores, jax_scores):
    ref = np.asarray(jax_scores)
    err = np.abs(port_scores.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _same_predictions(model, jmodel, xq):
    """Labels equal; a regressor's predictions are its scores (held above)."""
    if model.task != "svr":
        assert np.array_equal(model.predict(xq).numpy(),
                              np.asarray(jmodel.predict(jnp.asarray(xq))))


@pytest.mark.parametrize("task", TASKS)
def test_jax_artifact_serves_in_the_port(tmp_path, task):
    jmodel = mk_jax_model(task, seed=21)
    JRegistry(str(tmp_path)).save("m", jmodel)
    model, info = ModelRegistry(str(tmp_path)).load("m", device="cpu")
    assert info.fingerprint["kind"] == "hss_svm_serve_model"
    assert np.array_equal(model.x_perm.numpy(), np.asarray(jmodel.x_perm))
    assert np.array_equal(model.z_y.numpy(), np.asarray(jmodel.z_y))
    xq = _queries(model, seed=5)
    _close(model.decision_function(xq), jmodel.decision_function(jnp.asarray(xq)))
    _same_predictions(model, jmodel, xq)


@pytest.mark.parametrize("task", TASKS)
def test_port_artifact_serves_in_jax(tmp_path, task):
    model = mk_model(task, seed=22)
    ModelRegistry(str(tmp_path)).save("m", model)
    jmodel, info = JRegistry(str(tmp_path)).load("m")
    assert info.fingerprint == model_fingerprint(model)
    assert np.array_equal(np.asarray(jmodel.z_y), model.z_y.numpy())
    assert (jmodel.task, jmodel.strategy, jmodel.binary) == (model.task, model.strategy,
                                                             model.binary)
    xq = _queries(model, seed=6)
    _close(model.decision_function(xq), jmodel.decision_function(jnp.asarray(xq)))
    _same_predictions(model, jmodel, xq)


def test_fingerprints_agree_across_packages():
    for task in TASKS:
        assert model_fingerprint(mk_model(task)) == jfingerprint(mk_jax_model(task))
