"""The port's entry points for the kernel tasks, on the CPU.

``repro_torch.launch.serve`` for each kernel ``--task`` and
``repro_torch.launch.train --task svm|krr|gp`` at 1024 training points
and 3 requests, ``--device cpu``: every number comes back finite, the
served scores have the request's shape.  The svm grid's holdout accuracy
is within 0.02 of the JAX engine's on the same arguments (the two builds
may take other pivots on f32 rounding ties, so their models differ a
little).  The serve steps of an LM sharded over a mesh run (they raised
``NotImplementedError`` until serving on a mesh was ported).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.launch import serve, train
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

N_TRAIN, BATCH, REQUESTS = 1024, 32, 3
ACC_GAP = 0.02


def _finite(d):
    for v in d.values():
        if isinstance(v, float):
            assert math.isfinite(v)


@pytest.mark.parametrize("task", ["svm", "svr", "oneclass", "krr", "gp"])
def test_serve_kernel_task_on_cpu(task, tmp_path, capsys):
    argv = ["--task", task, "--device", "cpu", "--svm-train", str(N_TRAIN),
            "--batch", str(BATCH), "--requests", str(REQUESTS)]
    if task == "svm":      # through the registry, pruned, in bf16
        argv += ["--registry", str(tmp_path), "--prune-tol", "1e-3",
                 "--serve-dtype", "bfloat16"]
    out = serve.main(argv)
    _finite(out)
    st = out["stats"]
    assert st["requests"] == REQUESTS + 1 and st["launches"] == REQUESTS + 1
    assert st["support_uploads"] == 1 and st["graph_captures"] == 0
    scores = out["last_scores"]
    assert scores.shape == ((BATCH, 4) if task == "svm" else (BATCH,))
    assert np.isfinite(scores).all()
    if task == "svm":
        assert out["accuracy"] > 0.9
        assert "registered model 'svm' v1" in capsys.readouterr().out
    elif task == "oneclass":
        assert out["recall"] > 0.5
    else:
        assert out["rmse"] < 0.3


@pytest.mark.parametrize("task", ["krr", "gp"])
def test_train_regression_grid_on_cpu(task):
    out = train.main(["--task", task, "--device", "cpu", "--svm-train", str(N_TRAIN),
                      "--svm-test", "256", "--svm-c-grid", "0.5,2"])
    _finite(out)
    assert [g["knob"] for g in out["grid"]] == [0.5, 2.0]
    assert all(math.isfinite(g["rmse"]) and g["rmse"] < 0.3 for g in out["grid"])


def test_train_svm_grid_matches_the_jax_engine():
    from repro.core.compression import CompressionParams
    from repro.core.engine import HSSSVMEngine
    from repro.core.kernelfn import KernelSpec
    from repro.data import synthetic

    out = train.main(["--task", "svm", "--device", "cpu", "--svm-train", str(N_TRAIN),
                      "--svm-test", "256", "--svm-c-grid", "0.5,1", "--svm-leaf", "512"])
    _finite(out)
    # repro.launch.train's svm path on the same arguments (one device)
    xtr, ytr, xte, yte = synthetic.train_test("blobs", N_TRAIN, 256, seed=0)
    eng = HSSSVMEngine(spec=KernelSpec(h=1.0),
                       comp=CompressionParams(rank=32, n_near=48, n_far=64),
                       leaf_size=512, max_it=10, task="svm")
    eng.prepare(xtr, ytr)
    for g, model in zip(out["grid"], eng.train_grid([0.5, 1.0])):
        acc = float(np.mean(np.asarray(model.predict(jnp.asarray(xte))) == yte))
        assert abs(g["accuracy"] - acc) <= ACC_GAP, (g, acc)


def test_paths_not_ported_raise():
    """The serve steps of an LM sharded over a mesh raised until serving on a
    mesh was ported: they now run, and on a one-rank mesh they give the
    local run's logits bit for bit (tests/test_torch_serve_mesh.py holds
    them at 2 and 4 ranks against the JAX package)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.dist import api as dist_api, sharding
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_serve_steps

    cfg = get_config("zamba2-1.2b").reduced(compute_dtype="float32")
    batch = {"tokens": torch.arange(8)[None] % cfg.vocab}
    step = torch.full((1, 1), 3, dtype=torch.long)

    def run(model, mesh=None):
        prefill, decode = make_serve_steps(model, 16)
        with dist_api.use_mesh(mesh):
            logits, cache = prefill(batch)
            return logits, decode(cache, step)[0]

    local = run(Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    with dist_api.process_group_mesh("cpu") as mesh:
        model = sharding.shard_model(
            Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)), mesh)
        sharded = run(model, mesh)
    assert all(torch.equal(a, b) for a, b in zip(sharded, local))


def test_entry_points_default_to_the_card():
    assert serve.parser().parse_args([]).device == "cuda"
    assert train.parser().parse_args([]).device == "cuda"
