"""The port's LM training entry point (``launch.train --task lm``) on the CPU.

- ``--preset tiny --device cpu`` runs 3 steps of gemma2-9b (dense: the
  reference's SSD gradient overflows at the tiny preset's 128 positions,
  ``tests/test_torch_train_step.py``) and its losses and grad norms match
  the JAX step loop's (``repro.train.step.make_train_step`` under jit, as
  ``repro.launch.train`` runs it) from the launcher's initial weights
  (converted) on the same batches.  The tiny preset computes in bf16, so
  the bar is 1e-3 relative (bf16 rounds at other places in the two
  frameworks; the forward's bar is 5e-2 of the largest logit).
- zamba2-1.2b: 3 steps, save, restore and 3 more steps equal 6 uninterrupted
  steps bit for bit (the twin of ``tests/test_ckpt.py
  ::test_training_resume_bit_exact``); ``--fail-at`` restarts once, from the
  latest checkpoint, and ends on the same parameters.
- ``examples/lm_train_torch.py`` at the tiny preset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data.tokens import batch_for_config as jbatch_for_config
from repro.models.transformer import Model as JModel
from repro.train import optim as joptim, step as jstep
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.models.transformer import Model
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = ["--task", "lm", "--preset", "tiny", "--device", "cpu", "--log-every", "1"]


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters(), strict=True))


def test_tiny_run_matches_the_jax_step_loop(capsys):
    out = train.main(CPU + ["--arch", "gemma2-9b", "--steps", "3", "--batch", "2", "--seq", "32"])
    assert "step 2: loss=" in capsys.readouterr().out
    assert out["restarts"] == 0 and out["peak_device_bytes"] is None
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    cfg = jget_config("gemma2-9b").reduced()
    jm = JModel(cfg)
    start = train.init_weights(Model(train.lm_config("gemma2-9b", "tiny"), device="cpu"))
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(start))
    opt = joptim.adamw_init(params, joptim.AdamWConfig())
    step_fn = jax.jit(jstep.make_train_step(jm, joptim.AdamWConfig()))
    for k in range(3):
        batch = jax.tree.map(jnp.asarray, jbatch_for_config(cfg, 2, 32, k))
        params, opt, met = step_fn(params, opt, batch)
        assert out["losses"][k] == pytest.approx(float(met["loss"]), rel=1e-3)
        assert out["grad_norms"][k] == pytest.approx(float(met["grad_norm"]), rel=1e-2)


def test_resume_is_bit_exact(tmp_path):
    args = CPU + ["--arch", "zamba2-1.2b", "--seq", "64", "--batch", "2"]
    full = train.main(args + ["--steps", "6"])
    first = train.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    rest = train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert rest["resumed_from"] == [3] and rest["steps_run"] == [3, 4, 5]
    assert first["losses"] + rest["losses"] == full["losses"]
    assert _params_equal(rest["model"], full["model"])
    for a, b in ((rest["opt_state"].m, full["opt_state"].m),
                 (rest["opt_state"].v, full["opt_state"].v)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(rest["opt_state"].step) == int(full["opt_state"].step) == 6


def test_fail_at_restarts_once(tmp_path, capsys):
    args = CPU + ["--arch", "zamba2-1.2b", "--seq", "64", "--batch", "2", "--steps", "6"]
    clean = train.main(args)
    out = train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3", "--fail-at", "4"])
    assert out["restarts"] == 1 and out["resumed_from"] == [3]
    assert "resumed from step 3" in capsys.readouterr().out
    assert out["losses"] == clean["losses"] and _params_equal(out["model"], clean["model"])
    assert len(out["step_ms"]) == 7          # step 3 ran twice


def test_lm_needs_an_arch_and_the_card_by_default():
    with pytest.raises(SystemExit):
        train.main(["--task", "lm", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--task", "lm", "--arch", "gemma2-9b", "--steps", "1"])


def test_example_runs_at_the_tiny_preset(tmp_path):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "lm_train_torch.py"
    spec = importlib.util.spec_from_file_location("lm_train_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--arch", "mamba2-780m", "--preset", "tiny", "--device", "cpu",
                        "--steps", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "1"])
    assert out["preset"] == "tiny" and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
