"""The port's streamed out-of-core HSS build against the JAX package, on the CPU.

tests/test_streaming.py's fast tier on ``repro_torch``: at batch sizes that
divide the leaf count, exceed it and straddle it, the port's
``compress_streamed`` gives the JAX package's skeleton ids exactly, its
matvec to 1e-5, and the JAX streamed build's ``peak_stream_bytes`` and
batch count exactly (both are counts of shapes); the solve, the batch-bound
peak, host assembly, the flat-tree refusal, kill-and-resume bit for bit
(in-process and by a fresh call), a foreign checkpoint ignored, the
streamed engine end to end against the JAX streamed engine, and
``compression_error`` on the JAX package's own probe block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.compression import CompressionParams as JParams, StreamParams as JStream
from repro.core.engine import HSSSVMEngine as JEngine
from repro.core.kernelfn import KernelSpec as JSpec
from repro.data import synthetic
from repro_torch.core import compression as tcomp
from repro_torch.core import factorization as tfact
from repro_torch.core import tree as tree_mod
from repro_torch.core.admm import ADMMParams
from repro_torch.core.compression import CompressionParams as TParams, StreamParams as TStream
from repro_torch.core.engine import HSSSVMEngine as TEngine
from repro_torch.core.hss import HSSMatrix
from repro_torch.core.kernelfn import KernelSpec as TSpec
from repro_torch.dist.fault import FailureInjector, InjectedFailure
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")
H = 1.5


def _problem(n=512, f=4, leaf=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    t = tree_mod.build_tree(x, leaf_size=leaf)
    return x[t.perm], t


def _params(adaptive, cls=TParams):
    return cls(rank=12, n_near=16, n_far=16, rtol=1e-3 if adaptive else None)


def _tensors(hss: HSSMatrix):
    out = [hss.x, hss.d_leaf, hss.u_leaf, hss.skel_leaf, *hss.transfers, *hss.skels,
           *hss.b_mats, *hss.level_ranks]
    return out + ([hss.leaf_ranks] if hss.leaf_ranks is not None else [])


def _assert_bit_identical(a: HSSMatrix, b: HSSMatrix):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for u, v in zip(ta, tb):
        assert u.dtype == v.dtype and torch.equal(u.cpu(), v.cpu())


def _stream(xp, t, params, **kw):
    return tcomp.compress_streamed(xp, t, TSpec(h=H), params, TStream(**kw), device="cpu")


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("batch_leaves", [1, 3, 64])
def test_streamed_matches_jax(adaptive, batch_leaves):
    """Skeleton ids EXACT against the JAX resident build, matvec to 1e-5,
    and peak bytes and batch count equal to the JAX streamed build's."""
    xp, t = _problem()
    ref = jcomp.compress(xp, t, JSpec(h=H), _params(adaptive, JParams))
    _, jstats = jcomp.compress_streamed(xp, t, JSpec(h=H), _params(adaptive, JParams),
                                        stream=JStream(batch_leaves=batch_leaves))
    hss, stats = _stream(xp, t, _params(adaptive), batch_leaves=batch_leaves)
    np.testing.assert_array_equal(hss.skel_leaf.numpy(), np.asarray(ref.skel_leaf))
    for got, want in zip(hss.skels, ref.skels):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if adaptive:
        np.testing.assert_array_equal(hss.leaf_ranks.numpy(), np.asarray(ref.leaf_ranks))
    v = np.random.default_rng(1).normal(size=(t.n, 3)).astype(np.float32)
    np.testing.assert_allclose(hss.matmat(torch.as_tensor(v)).numpy(),
                               np.asarray(ref.matmat(jnp.asarray(v))), rtol=1e-5, atol=1e-5)
    assert stats.peak_stream_bytes == jstats.peak_stream_bytes > 0
    assert stats.n_batches == jstats.n_batches > 0
    assert stats.resumed_level is None and stats.restarts == 0
    assert stats.device_peak_bytes is None          # measured on a CUDA card only


@pytest.mark.parametrize("adaptive", [False, True])
def test_streamed_counts_the_resident_kernel_evals(adaptive):
    """The same seams see the same blocks: the eval count is the resident
    build's, and ``kernel_eval_count``'s."""
    xp, t = _problem()
    params = _params(adaptive)
    with tcomp.counting_kernel_evals() as resident:
        tcomp.compress(xp, t, TSpec(h=H), params, device="cpu")
    with tcomp.counting_kernel_evals() as streamed:
        _stream(xp, t, params, batch_leaves=3)
    assert streamed["count"] == resident["count"] == tcomp.kernel_eval_count(t, params)


def test_streamed_solve_matches_resident():
    xp, t = _problem()
    params = _params(True)
    ref = tcomp.compress(xp, t, TSpec(h=H), params, device="cpu")
    hss, _ = _stream(xp, t, params, batch_leaves=4)
    v = torch.as_tensor(np.random.default_rng(2).normal(size=(t.n, 2)), dtype=torch.float32)
    np.testing.assert_allclose(tfact.factorize(hss, 4.0).solve_mat(v).numpy(),
                               tfact.factorize(ref, 4.0).solve_mat(v).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_streamed_peak_bytes_batch_bounded_and_flat_in_n():
    params = _params(False)
    peaks = {}
    for bl in (2, 32):
        xp, t = _problem(n=512)
        peaks[bl] = _stream(xp, t, params, batch_leaves=bl)[1].peak_stream_bytes
    assert peaks[2] < peaks[32], peaks
    xp2, t2 = _problem(n=2048, seed=3)
    peak2 = _stream(xp2, t2, params, batch_leaves=2)[1].peak_stream_bytes
    assert peak2 <= int(1.05 * peaks[2]), (peak2, peaks[2])


def test_streamed_host_assembly_matches_device():
    xp, t = _problem()
    params = _params(False)
    dev, _ = _stream(xp, t, params, batch_leaves=8)
    host, _ = _stream(xp, t, params, batch_leaves=8, assemble="host")
    assert host.d_leaf.device.type == "cpu"
    _assert_bit_identical(host, dev)
    with pytest.raises(ValueError, match="assemble"):
        _stream(xp, t, params, assemble="disk")


def test_streamed_rejects_flat_tree():
    xp, t = _problem(n=32, leaf=32)
    assert t.levels == 0
    with pytest.raises(ValueError, match="at least one tree level"):
        _stream(xp, t, _params(False))


# --------------------------------------------------------------------- #
# checkpointed resume                                                   #
# --------------------------------------------------------------------- #
def test_streamed_kill_and_resume_bit_identical(tmp_path):
    xp, t = _problem(n=1024, leaf=32)            # 5 levels -> failure at level 2
    params = _params(True)
    ref, _ = _stream(xp, t, params, batch_leaves=8)
    hss, stats = tcomp.compress_streamed(
        xp, t, TSpec(h=H), params, TStream(batch_leaves=8, ckpt_dir=str(tmp_path)),
        on_level=FailureInjector(fail_at=(2,)).check, device="cpu")
    _assert_bit_identical(hss, ref)
    assert stats.restarts == 1 and stats.resumed_level == 2
    assert stats.checkpointed_levels == t.levels + 1
    assert stats.ckpt_save_s > 0 and stats.ckpt_load_s > 0


def test_streamed_fresh_call_resumes_from_directory(tmp_path):
    xp, t = _problem(n=1024, leaf=32)
    params = _params(False)
    ref, _ = _stream(xp, t, params, batch_leaves=8)
    with pytest.raises(InjectedFailure):
        tcomp.compress_streamed(
            xp, t, TSpec(h=H), params,
            TStream(batch_leaves=8, ckpt_dir=str(tmp_path), max_restarts=0),
            on_level=FailureInjector(fail_at=(3,)).check, device="cpu")
    hss, stats = _stream(xp, t, params, batch_leaves=8, ckpt_dir=str(tmp_path))
    _assert_bit_identical(hss, ref)
    assert stats.resumed_level == 3 and stats.restarts == 0


def test_streamed_foreign_checkpoint_ignored(tmp_path):
    xp, t = _problem(n=1024, leaf=32)
    params = _params(False)
    _stream(xp, t, params, batch_leaves=8, ckpt_dir=str(tmp_path))
    other = TSpec(h=7.0)
    ref, _ = tcomp.compress_streamed(xp, t, other, params, TStream(batch_leaves=8),
                                     device="cpu")
    hss, stats = tcomp.compress_streamed(
        xp, t, other, params, TStream(batch_leaves=8, ckpt_dir=str(tmp_path)), device="cpu")
    assert stats.resumed_level is None
    _assert_bit_identical(hss, ref)


# --------------------------------------------------------------------- #
# engine end to end, and the probe diagnostic                            #
# --------------------------------------------------------------------- #
def test_engine_streamed_matches_jax_streamed_engine():
    """test_torch_engine.py's tolerances: duals to 1e-5 of C, bias to 1e-4,
    the same predictions; the stream record equal to the JAX engine's."""
    xtr, ytr, xte, _ = synthetic.train_test("blobs", 1024, 256, seed=0, sep=1.6)
    comp = dict(rank=16, n_near=16, n_far=24)
    je = JEngine(spec=JSpec(h=1.0), comp=JParams(**comp), leaf_size=64, max_it=10,
                 stream=JStream(batch_leaves=4))
    jm = je.fit(xtr, ytr, c_value=1.0)
    te = TEngine(spec=TSpec(h=1.0), comp=TParams(**comp), leaf_size=64,
                 admm=ADMMParams(max_it=10), stream=TStream(batch_leaves=4), device="cpu")
    te.prepare(xtr, ytr)
    tm, (tz, _) = te.train(1.0)
    _, (jz, _) = je.train(1.0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.biases.numpy(), np.asarray(jm.biases), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tm.predict(xte).numpy(), np.asarray(jm.predict(xte)))
    rt, rj = te.report, je.report
    assert (rt.peak_stream_bytes, rt.stream_batches, rt.stream_resumed_level,
            rt.stream_restarts) == (rj.peak_stream_bytes, rj.stream_batches,
                                    rj.stream_resumed_level, rj.stream_restarts)
    assert rt.kernel_evals == rj.kernel_evals and rt.ranks_post == rj.ranks_post
    assert rt.stream_device_peak_bytes is None


def test_engine_streamed_host_assembly_trains_on_its_device():
    xtr, ytr, xte, _ = synthetic.train_test("blobs", 512, 64, seed=1, sep=1.6)
    kw = dict(spec=TSpec(h=1.0), comp=TParams(rank=12, n_near=16, n_far=16), leaf_size=64,
              admm=ADMMParams(max_it=5), device="cpu")
    a = TEngine(stream=TStream(batch_leaves=2), **kw).fit(xtr, ytr)
    b = TEngine(stream=TStream(batch_leaves=2, assemble="host"), **kw).fit(xtr, ytr)
    assert torch.equal(a.z_y, b.z_y) and torch.equal(a.biases, b.biases)


@pytest.mark.parametrize("seed", [0, 3])
def test_compression_error_matches_jax(seed):
    xp, t = _problem(n=256, leaf=32)
    params = _params(False)
    jhss = jcomp.compress(xp, t, JSpec(h=H), _params(False, JParams))
    want = float(jcomp.compression_error(jhss, JSpec(h=H), n_probe=8, seed=seed))
    probes = np.array(jax.random.normal(jax.random.PRNGKey(seed), (t.n, 8), jnp.float32))
    hss, _ = _stream(xp, t, params, batch_leaves=4)
    got = float(tcomp.compression_error(hss, TSpec(h=H), torch.as_tensor(probes)))
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 1e-5 * max(1.0, want) + 1e-6


def test_jax_fingerprint_is_not_resumed_by_the_port(tmp_path):
    """A JAX streamed build's checkpoint names another implementation, so
    the port starts afresh instead of mixing the two packages' numerics."""
    xp, t = _problem(n=512, leaf=32)
    jcomp.compress_streamed(xp, t, JSpec(h=H), _params(False, JParams),
                            stream=JStream(batch_leaves=4, ckpt_dir=str(tmp_path)))
    ref, _ = _stream(xp, t, _params(False), batch_leaves=4)
    hss, stats = _stream(xp, t, _params(False), batch_leaves=4, ckpt_dir=str(tmp_path))
    assert stats.resumed_level is None
    _assert_bit_identical(hss, ref)
