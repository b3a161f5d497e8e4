"""The port's ``examples/*_torch.py`` at toy sizes on the CPU.

Each example's ``main`` with ``--device cpu`` and a few hundred points: it
runs through, prints what its JAX twin prints, and its numbers are sane
(the examples' quality at their real sizes is the engine tests' business).
``distributed_svm_torch`` spawns two gloo ranks itself; every example
defaults to the card.
"""
import importlib
import os
import sys

import numpy as np
import pytest

import torch_dist_ranks as ranks
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")
sys.path.insert(0, EXAMPLES)

SMALL = ["--device", "cpu", "--n-train", "1024", "--n-test", "256"]
NAMES = ["quickstart", "svm_gridsearch", "multiclass_svm", "svr", "one_class", "krr",
         "spectral_embedding", "serve_demo", "distributed_svm"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with ranks.torch_threads(1):
        yield


def _example(name):
    return importlib.import_module(f"{name}_torch")


def test_every_example_defaults_to_the_card():
    for name in NAMES:
        mod = _example(name)
        if hasattr(mod, "parser"):
            assert mod.parser().parse_args([]).device == "cuda", name
    from repro_torch.launch import serve
    assert serve.parser().parse_args([]).device == "cuda"      # serve_demo's


def test_quickstart_and_gridsearch(capsys):
    out = _example("quickstart").main(SMALL)
    assert out["accuracy"] > 0.9
    info = _example("svm_gridsearch").main(SMALL)
    assert len(info["results"]) == 6 and info["best_accuracy"] > 0.6
    text = capsys.readouterr().out
    assert "test accuracy" in text and "2 compressions" in text


def test_multiclass(capsys):
    out = _example("multiclass_svm").main(SMALL)
    assert out["ovr"] > 0.8 and out["ovo"] > 0.8
    assert len(out["grid"]["results"]) == 6
    assert "3-class spirals" in capsys.readouterr().out


def test_svr_one_class_krr():
    svr = _example("svr").main(SMALL)
    assert min(svr["sweep"].values()) < 0.3
    oc = _example("one_class").main(SMALL)
    assert all(0.0 <= m["recall"] <= 1.0 for m in oc["sweep"].values())
    assert oc["grid"]["best_accuracy"] > 0.6
    krr = _example("krr").main(SMALL)
    assert min(krr["sweep"].values()) < 0.3 and np.isfinite(krr["gp"]["best_log_marginal"])


def test_spectral_embedding_and_serve_demo(capsys):
    out = _example("spectral_embedding").main(["--device", "cpu", "--n", "1024"])
    assert np.all(np.diff(out["evals"]) <= 0) and out["purity_embedding"] >= out["purity_raw"]
    res = _example("serve_demo").main(["--device", "cpu", "--gen", "2", "--prompt-len", "8",
                                       "--batch", "1"])
    assert res["arch"] == "gemma2-9b" and res["tokens"].shape[1] >= 2
    assert "prefill" in capsys.readouterr().out


def test_distributed_svm_spawns_its_ranks():
    """Two gloo ranks: each holds half of e_leaf's leaves, both see the
    same holdout accuracy per C."""
    out = _example("distributed_svm").main(["--ranks", "2", "--device", "cpu", "--n-train",
                                            "2048", "--n-test", "256", "--c-grid", "0.1,1"])
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["mesh_ranks"] == 2 and o["e_leaf"][0] == 4 for o in out)
    assert out[0]["accuracy"] == out[1]["accuracy"] and out[0]["accuracy"][-1] > 0.9
