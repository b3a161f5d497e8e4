"""The port's checkpoint layer and fault-tolerance loop, on the CPU.

The checkpoint cases of tests/test_ckpt.py on ``repro_torch.ckpt``; the
format held across the two packages in both directions, bit for bit, with an
f32, an int32 and a bfloat16 leaf; the ``codec`` manifest key; the cases of
tests/test_fault.py on ``repro_torch.dist.fault``; and one import guard:
with jax, ml_dtypes and zstandard unimportable (the GPU machine's
situation), every module of the port imports and a checkpointed streamed
build and a registry round trip run.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.dist import fault
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.as_tensor(r.normal(size=(16, 8)), dtype=torch.float32),
                   "b": torch.as_tensor(r.normal(size=(8,)), dtype=torch.bfloat16)},
        "opt": {"m": torch.as_tensor(r.normal(size=(16, 8)), dtype=torch.float32),
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_tree_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = torch.as_tensor(la[k]), torch.as_tensor(lb[k])
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def test_save_load_roundtrip(tmp_path):
    tree = _tree()
    tckpt.save_checkpoint(str(tmp_path), tree, step=7, n_shards=3)
    out, step = tckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert isinstance(out["params"]["b"], torch.Tensor)
    _assert_tree_equal(tree, out)


def test_latest_step_and_retention(tmp_path):
    tree = _tree()
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(tree, s)
        mgr.wait()
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert sorted(int(x.split("_")[1]) for x in os.listdir(tmp_path)) == [3, 4]


def test_async_save_snapshots_before_returning(tmp_path):
    """save_async copies the tree before it returns: a later in-place update
    does not reach the checkpoint, and restore drains the write first."""
    tree = _tree()
    want = tree["params"]["w"].clone()
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save_async(tree, 1)
    tree["params"]["w"].add_(1.0)
    out, step = mgr.restore(tree)
    assert step == 1 and torch.equal(out["params"]["w"], want)


def test_load_checkpoint_arrays_template_free(tmp_path):
    state = {"d_leaf": np.arange(24, dtype=np.float32).reshape(4, 6),
             "skel": np.arange(8, dtype=np.int32),
             "ranks": np.asarray([3, 2, 3, 1], np.int32)}
    fp = dict(kind="hss_streamed_build", n=128, h=1.5)
    tckpt.save_checkpoint(str(tmp_path), state, step=2, n_shards=3, extra=fp)
    arrays, step, extra = tckpt.load_checkpoint_arrays(str(tmp_path))
    assert step == 2 and extra == fp and set(arrays) == set(state)
    for k in state:
        assert isinstance(arrays[k], np.ndarray) and arrays[k].dtype == state[k].dtype
        assert arrays[k].flags.writeable
        np.testing.assert_array_equal(arrays[k], state[k])


@pytest.mark.parametrize("n_shards", [1, 7])
def test_shard_count_independence(tmp_path, n_shards):
    tree = _tree(1)
    tckpt.save_checkpoint(str(tmp_path), tree, step=1, n_shards=n_shards)
    out, _ = tckpt.load_checkpoint(str(tmp_path), tree)
    _assert_tree_equal(tree, out)


# --------------------------------------------------------------------- #
# across the two packages                                                #
# --------------------------------------------------------------------- #
def _cross_state(seed=2):
    r = np.random.default_rng(seed)
    return (r.normal(size=(10, 3)).astype(np.float32),
            r.integers(-5, 1000, size=(7,)).astype(np.int32),
            r.normal(size=(9, 2)).astype(np.float32))      # -> bf16


@pytest.mark.parametrize("n_shards", [1, 4])
def test_jax_checkpoint_loads_in_the_port(tmp_path, n_shards):
    f32, i32, b = _cross_state()
    jtree = {"f32": jnp.asarray(f32), "i32": jnp.asarray(i32),
             "bf16": jnp.asarray(b, jnp.bfloat16)}
    jckpt.save_checkpoint(str(tmp_path), jtree, step=5, n_shards=n_shards,
                          extra=dict(tag="jax"))
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        assert "codec" not in json.load(f)           # the JAX writer: zstd
    arrays, step, extra = tckpt.load_checkpoint_arrays(str(tmp_path))
    assert step == 5 and extra == dict(tag="jax")
    np.testing.assert_array_equal(arrays["f32"], f32)
    np.testing.assert_array_equal(arrays["i32"], i32)
    assert arrays["i32"].dtype == np.int32
    assert arrays["bf16"].dtype == torch.bfloat16
    want = np.asarray(jtree["bf16"]).view(np.int16)
    np.testing.assert_array_equal(arrays["bf16"].view(torch.int16).numpy(), want)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_port_checkpoint_loads_in_jax(tmp_path, n_shards):
    f32, i32, b = _cross_state(3)
    ttree = {"f32": torch.as_tensor(f32), "i32": torch.as_tensor(i32),
             "bf16": torch.as_tensor(b).to(torch.bfloat16)}
    tckpt.save_checkpoint(str(tmp_path), ttree, step=9, n_shards=n_shards,
                          extra=dict(tag="port"))
    arrays, step, extra = jckpt.load_checkpoint_arrays(str(tmp_path))
    assert step == 9 and extra == dict(tag="port")
    np.testing.assert_array_equal(arrays["f32"], f32)
    np.testing.assert_array_equal(arrays["i32"], i32)
    assert str(arrays["bf16"].dtype) == "bfloat16"
    np.testing.assert_array_equal(arrays["bf16"].view(np.int16),
                                  ttree["bf16"].view(torch.int16).numpy())


def test_raw_codec_read_back(tmp_path, monkeypatch):
    """Written where zstandard is missing, read where it is installed."""
    tree = _tree(4)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "zstandard", None)
        tckpt.save_checkpoint(str(tmp_path), tree, step=1)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["codec"] == "raw"
    w = tree["params"]["w"]
    shard = (tmp_path / "step_00000001" / "params.w.0.npz").read_bytes()
    assert shard == w[:4].numpy().tobytes()          # raw bytes, no framing
    out, _ = tckpt.load_checkpoint(str(tmp_path), tree)
    _assert_tree_equal(tree, out)


def test_zstd_shard_without_zstandard_raises(tmp_path, monkeypatch):
    tckpt.save_checkpoint(str(tmp_path), _tree(), step=1)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["codec"] == "zstd"
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        tckpt.load_checkpoint_arrays(str(tmp_path))


def test_save_without_zstandard_writes_raw(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    tree = _tree(5)
    tckpt.save_checkpoint(str(tmp_path), tree, step=3)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["codec"] == "raw"
    out, step = tckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 3
    _assert_tree_equal(tree, out)


def test_unknown_codec_rejected(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _tree(), step=1)
    path = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(path.read_text())
    path.write_text(json.dumps(dict(manifest, codec="lz4")))
    with pytest.raises(ValueError, match="codec"):
        tckpt.load_checkpoint_arrays(str(tmp_path))


# --------------------------------------------------------------------- #
# dist/fault.py (tests/test_fault.py's cases, deadlines under 0.5 s)      #
# --------------------------------------------------------------------- #
def test_step_guard_passes_results():
    assert fault.StepGuard(deadline_s=0.4).run(0, lambda: 42) == 42


def test_step_guard_timeout():
    with pytest.raises(fault.StepTimeout):
        fault.StepGuard(deadline_s=0.05).run(0, lambda: time.sleep(0.3))


def test_step_guard_detects_straggler():
    g = fault.StepGuard(deadline_s=0.45, straggler_ratio=3.0)
    for i in range(6):
        g.run(i, lambda: time.sleep(0.01))
    g.run(6, lambda: time.sleep(0.15))
    assert len(g.stragglers) == 1
    assert g.stragglers[0].ratio > 3.0 and g.stragglers[0].step == 6


def test_step_guard_reraises_the_step_error():
    def boom():
        raise KeyError("x")

    with pytest.raises(KeyError):
        fault.StepGuard(deadline_s=0.4).run(0, boom)


def test_run_resilient_restarts_from_checkpoint():
    saved = {}

    def save(state, step_no):
        saved["state"], saved["step"] = dict(state), step_no

    def restore():
        return (dict(saved["state"]), saved["step"]) if "state" in saved else None

    injector = fault.FailureInjector((7,))

    def step(state, i):
        injector.check(i)
        return {"x": state["x"] + 1.0}

    final, report = fault.run_resilient(12, lambda: {"x": 0.0}, step, save, restore,
                                        ckpt_every=5, guard=fault.StepGuard(deadline_s=0.4))
    assert report["restarts"] == 1
    assert final["x"] == 12.0      # no steps lost or double-counted
    assert saved["step"] == 12     # the final save (12 is off the cadence)


def test_run_resilient_gives_up_after_max_restarts():
    def step(state, i):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="always fails"):
        fault.run_resilient(3, dict, step, lambda s, i: None, lambda: None,
                            max_restarts=2, guard=fault.StepGuard(deadline_s=0.4))


def test_run_resilient_reports_a_failed_final_save():
    def save(state, k):
        raise OSError("disk full")

    final, report = fault.run_resilient(3, lambda: 0, lambda s, i: s + 1, save,
                                        lambda: None)
    assert final == 3 and "disk full" in report["final_save_error"]


def test_failure_injector_fires_once():
    inj = fault.FailureInjector((2,))
    inj.check(1)
    with pytest.raises(fault.InjectedFailure):
        inj.check(2)
    inj.check(2)   # second pass after restart: no raise


# --------------------------------------------------------------------- #
# the GPU machine's situation: no jax, no ml_dtypes, no zstandard         #
# --------------------------------------------------------------------- #
def test_port_runs_without_jax_ml_dtypes_and_zstandard(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "ml_dtypes", "zstandard"):
            sys.modules[name] = None
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        import importlib, json, pkgutil
        import numpy as np, torch
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in mods:
            importlib.import_module(name)
        assert not any(k == "repro" or k.startswith(("repro.", "jax")) for k in sys.modules
                       if sys.modules[k] is not None)
        from repro_torch.core import compression as C, tree as tree_mod
        from repro_torch.core.kernelfn import KernelSpec
        from repro_torch.core.engine import EngineModel
        from repro_torch.serve import ModelRegistry
        x = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32)
        t = tree_mod.build_tree(x, leaf_size=16)
        sp = C.StreamParams(batch_leaves=2, ckpt_dir={str(tmp_path / "ck")!r})
        hss, st = C.compress_streamed(x[t.perm], t, KernelSpec(h=1.0),
                                      C.CompressionParams(rank=6, n_near=8, n_far=8),
                                      sp, device="cpu")
        man = json.load(open({str(tmp_path / "ck")!r} + f"/step_{{t.levels + 1:08d}}/manifest.json"))
        assert man["codec"] == "raw", man["codec"]
        again, st2 = C.compress_streamed(x[t.perm], t, KernelSpec(h=1.0),
                                         C.CompressionParams(rank=6, n_near=8, n_far=8),
                                         sp, device="cpu")
        assert st2.resumed_level == t.levels + 1 and torch.equal(again.d_leaf, hss.d_leaf)
        reg = ModelRegistry({str(tmp_path / "reg")!r})
        m = EngineModel(x_perm=torch.as_tensor(x), z_y=torch.ones(128, 1), biases=torch.zeros(1),
                        classes=np.array([-1.0, 1.0], np.float32), spec=KernelSpec(h=1.0),
                        c_value=1.0)
        reg.save("m", m)
        back, info = reg.load("m", device="cpu")
        assert torch.equal(back.x_perm, m.x_perm) and torch.equal(back.z_y, m.z_y)
        print("GUARD_OK", len(mods))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0 and "GUARD_OK" in r.stdout, r.stdout + r.stderr[-4000:]
