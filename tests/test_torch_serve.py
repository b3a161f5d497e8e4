"""The port's serving engine against the JAX package's, on the CPU.

tests/test_serve.py's cases, each driving ``repro.serve.ServingEngine`` and
``repro_torch.serve.ServingEngine`` with the same requests: synthetic
models (its ``mk_model``, d 96, f 4, no training) carried into the port
with ``convert.engine_model_from_numpy(device="cpu")``, then one small
model trained by the JAX engine and served by both.

Tolerances, each of the largest |score|:
  * f32 scores: 1e-5 (f32 kernel blocks and products summed in another
    order); predictions equal;
  * bf16 scores: the port against the JAX package's bf16 path within
    BF16_PORT_RTOL, and each within the reference's BF16_ATOL 2e-2 of its
    own f32 scores (absolute, as tests/test_serve.py pins it).
``stats()`` must be equal key by key on the reference's keys.

Where the reference asserts bit equality (a served f32 score against the
model's own ``decision_function``), the port asserts it too where the
tick's matmul has the shape of ``decision_function``'s: the group holds
that model alone and the queries fill their bucket.  Elsewhere the score
matmul has another row count (a padded bucket) or column count (a shared
group), the CPU's BLAS may then sum in another order, and those scores
are held at 1e-6 of the largest |score|.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineModel as JModel
from repro.core.kernelfn import KernelSpec as JSpec
from repro.serve import BatchPolicy as JPolicy, ModelRegistry as JRegistry
from repro.serve import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.serve import BatchPolicy, ModelRegistry, ServingEngine, batched_scores
from repro_torch.serve.engine import _ovo_vote_np
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

TASKS = ("binary", "ovr", "ovo", "svr", "oneclass", "krr", "gp")
F32_RTOL = 1e-5
SHARED_RTOL = 1e-6
BF16_ATOL = 2e-2
# The port's bf16 path against the reference's: both round the same
# operands to bf16 and sum exact f32 products in f32, in other orders; the
# Gaussian's exp then moves each entry by up to its slope times an f32
# ulp of the squared distance (~1e-6 here).
BF16_PORT_RTOL = 1e-5


def mk_jax_model(task="binary", d=96, f=4, h=1.3, beta=64.0, seed=0, kernel="gaussian",
                 impl="xla"):
    """tests/test_serve.py's synthetic EngineModel (no training)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(d, f)).astype(np.float32)
    n_prob = 3 if task in ("ovr", "ovo") else 1
    zy = (0.3 * r.normal(size=(d, n_prob))).astype(np.float32)
    biases = (0.1 * r.normal(size=n_prob)).astype(np.float32)
    classes = (np.arange(3.0, dtype=np.float32) if n_prob == 3
               else np.array([-1.0, 1.0], np.float32))
    pairs = np.array([[0, 1], [0, 2], [1, 2]], np.int32) if task == "ovo" else None
    return JModel(
        x_perm=jnp.asarray(x), z_y=jnp.asarray(zy), biases=jnp.asarray(biases),
        classes=classes, spec=JSpec(name=kernel, h=h, impl=impl), c_value=1.0,
        binary=task == "binary", strategy="ovo" if task == "ovo" else "ovr",
        task=task if task in ("svr", "oneclass", "krr", "gp") else "svm",
        pairs=pairs, beta=beta)


def port(m):
    """The JAX model's arrays as the port's EngineModel on the CPU."""
    return convert.engine_model_from_numpy(
        x_perm=np.asarray(m.x_perm), z_y=np.asarray(m.z_y), biases=np.asarray(m.biases),
        classes=np.asarray(m.classes), h=m.spec.h, kernel_name=m.spec.name, beta=m.beta,
        c_value=m.c_value, binary=m.binary, strategy=m.strategy, task=m.task,
        pairs=m.pairs, device="cpu")


def _queries(n=37, f=4, seed=1):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def engines(policy=None, **kw):
    """(JAX engine, port engine) under the same policy."""
    policy = policy or {}
    return (JEngine(policy=JPolicy(**policy), **kw),
            ServingEngine(policy=BatchPolicy(**policy), device="cpu", **kw))


def same_stats(je, pe):
    js, ps = je.stats(), pe.stats()
    assert {k: ps[k] for k in js} == js


def close(a, b, rtol, ref=None):
    ref = np.abs(np.asarray(b if ref is None else ref)).max()
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=rtol * max(ref, 1e-30))


# --------------------------------------------------------------------- #
# scoring parity: the 7 tasks, f32 and bf16                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("task", TASKS)
def test_f32_and_bf16_ticks_match_the_reference(task):
    jm = mk_jax_model(task, seed=3)
    pm = port(jm)
    xq = _queries(n=64)
    out = {}
    for dt in ("float32", "bfloat16"):
        je, pe = engines(dict(compute_dtype=dt))
        jid, pid = je.add_model(jm), pe.add_model(pm)
        out[dt] = je.score(jid, xq), pe.score(pid, xq)
        same_stats(je, pe)
    (js, jp), (ps, pp) = out["float32"]
    close(ps, js, F32_RTOL)
    if task in ("svr", "krr", "gp"):
        close(pp, jp, F32_RTOL)
    else:
        assert np.array_equal(pp, jp)
    # the port's f32 tick is its own decision_function, bit for bit
    assert np.array_equal(ps, pm.decision_function(xq).numpy())
    assert np.array_equal(pp, pm.predict(xq).numpy())
    (j16, _), (p16, p16_pred) = out["bfloat16"]
    close(p16, j16, BF16_PORT_RTOL)
    np.testing.assert_allclose(p16, ps, rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(j16, js, rtol=0, atol=BF16_ATOL)
    if task not in ("svr", "krr", "gp"):
        margin = np.min(np.abs(ps), axis=-1) if ps.ndim > 1 else np.abs(ps)
        clear = margin > BF16_ATOL
        assert np.array_equal(np.asarray(p16_pred)[clear], np.asarray(pp)[clear])


def test_bf16_scorer_returns_f32_from_bf16_rounded_operands():
    """The bf16 Gaussian path is the f64 evaluation of the bf16-rounded
    operands to f32 rounding: its products are not rounded to bf16."""
    jm = mk_jax_model("ovr", seed=4)
    pm = port(jm)
    xq = torch.as_tensor(_queries(n=16))
    got = batched_scores(xq, pm.x_perm, pm.z_y, pm.biases, spec=pm.spec, block=8,
                         compute_dtype="bfloat16")
    assert got.dtype == torch.float32
    r = lambda t: t.to(torch.bfloat16).double()
    a, b, v = r(xq), r(pm.x_perm), r(pm.z_y)
    sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    want = torch.exp(-sq / (2 * pm.spec.h ** 2)) @ v + pm.biases.double()
    close(got.numpy(), want.numpy(), 1e-5)


def test_laplacian_kernel_serves_too():
    """f32 against the reference's default (XLA) block; bf16 against its
    Pallas kernel in interpret mode, whose L1 sums run in f32 as K4's do
    (``laplacian_block_xla`` sums bf16 in bf16: ROADMAP queue 3)."""
    xq = _queries(n=64)
    for dt, impl in (("float32", "xla"), ("bfloat16", "pallas_interpret")):
        jm = mk_jax_model("binary", h=1.5, kernel="laplacian", impl=impl)
        pm = port(jm)
        je, pe = engines(dict(compute_dtype=dt))
        js, _ = je.score(je.add_model(jm), xq)
        ps, _ = pe.score(pe.add_model(pm), xq)
        close(ps, js, F32_RTOL if dt == "float32" else BF16_PORT_RTOL)
        same_stats(je, pe)
        if dt == "float32":
            assert np.array_equal(ps, pm.decision_function(xq).numpy())


# --------------------------------------------------------------------- #
# the shared-factorization cache                                         #
# --------------------------------------------------------------------- #
def _same_group_models(task="binary", seed=7):
    base = mk_jax_model(task, seed=seed)
    return [base] + [dataclasses.replace(base, z_y=base.z_y * s, biases=base.biases + s)
                     for s in (0.5, 2.0)]


def test_same_factorization_models_share_one_cache_entry():
    jms = _same_group_models()
    je, pe = engines()
    jids = [je.add_model(m) for m in jms]
    pids = [pe.add_model(port(m)) for m in jms]
    xq = _queries()
    jt = [je.submit(i, xq) for i in jids]
    pt = [pe.submit(i, xq) for i in pids]
    assert je.flush() == pe.flush() == 3
    st = pe.stats()
    assert (st["groups"], st["cache_entries"], st["support_uploads"], st["launches"]) \
        == (1, 1, 1, 1)
    assert st["resident_support_bytes"] == np.asarray(jms[0].x_perm).nbytes
    same_stats(je, pe)
    group = pe.model_group(pids[0])
    assert all(pe.model_group(i) is group for i in pids)
    for a, b, m in zip(jt, pt, jms):
        (js, jp), (ps, pp) = a.result(timeout=0), b.result(timeout=0)
        close(ps, js, F32_RTOL)
        assert np.array_equal(pp, jp)
        close(ps, port(m).decision_function(xq).numpy(), SHARED_RTOL)


def test_distinct_bandwidths_do_not_share():
    a = mk_jax_model("binary", seed=1, h=1.0)
    b = dataclasses.replace(a, spec=JSpec(h=2.0))
    je, pe = engines()
    for m in (a, b):
        je.add_model(m), pe.add_model(port(m))
    assert pe.stats()["groups"] == 2
    same_stats(je, pe)


def test_lru_eviction_drops_device_state_only():
    ma, mb = mk_jax_model("binary", seed=1, h=1.0), mk_jax_model("binary", seed=2, h=2.0)
    je, pe = engines(max_resident=1)
    ja, jb = je.add_model(ma), je.add_model(mb)
    pa, pb = pe.add_model(port(ma)), pe.add_model(port(mb))
    xq = _queries()
    ra1 = pe.score(pa, xq)
    je.score(ja, xq)
    pe.score(pb, xq), je.score(jb, xq)
    st = pe.stats()
    assert st["cache_entries"] == 1 and st["evictions"] == 1
    same_stats(je, pe)
    ra2 = pe.score(pa, xq)
    je.score(ja, xq)
    st = pe.stats()
    assert st["support_uploads"] == 3 and st["evictions"] == 2
    assert pe.model_group(pb).xs_dev is None and pe.model_group(pb).xs_host is not None
    same_stats(je, pe)
    assert np.array_equal(ra1[0], ra2[0])


# --------------------------------------------------------------------- #
# dynamic batching                                                       #
# --------------------------------------------------------------------- #
def test_tick_deinterleaves_mixed_requests():
    base, other = _same_group_models("ovr")[:2]
    je, pe = engines()
    j1, j2 = je.add_model(base), je.add_model(other)
    p1, p2 = pe.add_model(port(base)), pe.add_model(port(other))
    reqs = [(0, _queries(n=5, seed=21)), (1, _queries(n=17, seed=22)),
            (0, _queries(n=1, seed=23)), (1, _queries(n=30, seed=24))]
    jt = [je.submit((j1, j2)[i], q) for i, q in reqs]
    pt = [pe.submit((p1, p2)[i], q) for i, q in reqs]
    assert je.flush() == pe.flush() == 4
    assert pe.stats()["launches"] == 1
    same_stats(je, pe)
    for (i, q), a, b in zip(reqs, jt, pt):
        (js, jp), (ps, pp) = a.result(timeout=0), b.result(timeout=0)
        assert ps.shape == js.shape == (q.shape[0], 3)
        close(ps, js, F32_RTOL)
        assert np.array_equal(pp, jp)
        close(ps, port((base, other)[i]).decision_function(q).numpy(), SHARED_RTOL)


def test_occupancy_pads_to_buckets_one_compile_each():
    m = mk_jax_model("binary", d=64)
    je, pe = engines(dict(buckets=(16, 64), block=32))
    jid, pid = je.add_model(m), pe.add_model(port(m))
    for occ in (1, 3, 7, 11, 16, 20, 40, 64):
        xq = _queries(n=occ, seed=occ)
        close(pe.score(pid, xq)[0], je.score(jid, xq)[0], F32_RTOL)
    assert pe.scorer_compiles() == 2
    same_stats(je, pe)


def test_oversize_tick_chunks_at_top_bucket():
    m = mk_jax_model("binary", d=64)
    je, pe = engines(dict(buckets=(16, 32), block=32))
    jid, pid = je.add_model(m), pe.add_model(port(m))
    xq = _queries(n=70)                  # 3 chunks: 32 + 32 + pad(6->16)
    ps, _ = pe.score(pid, xq)
    close(ps, je.score(jid, xq)[0], F32_RTOL)
    close(ps, port(m).decision_function(xq).numpy(), SHARED_RTOL)
    assert pe.stats()["launches"] == 3
    same_stats(je, pe)


def test_max_batch_triggers_tick_without_flush():
    m = mk_jax_model("binary", d=64)
    je, pe = engines(dict(max_batch=8, buckets=(16,)))
    pid, jid = pe.add_model(port(m)), je.add_model(m)
    t1 = pe.submit(pid, _queries(n=4, seed=1))
    j1 = je.submit(jid, _queries(n=4, seed=1))
    assert not t1.done and not j1.done
    t2 = pe.submit(pid, _queries(n=4, seed=2))     # hits max_batch
    j2 = je.submit(jid, _queries(n=4, seed=2))
    assert t1.done and t2.done and j1.done and j2.done
    close(t2.result(0)[0], j2.result(0)[0], F32_RTOL)
    same_stats(je, pe)


def test_threaded_driver_resolves_without_manual_flush():
    m = mk_jax_model("binary", d=64)
    pe = ServingEngine(policy=BatchPolicy(max_wait_ms=1.0), device="cpu")
    pid = pe.add_model(port(m))
    pe.start()
    try:
        assert pe.running
        # submitted from several threads at once: every request resolves,
        # each to its own rows
        results = {}

        def client(s):
            results[s] = pe.submit(pid, _queries(n=3, seed=s)).result(timeout=10.0)

        threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
    finally:
        pe.stop()
    assert not pe.running
    for s, (scores, _) in results.items():
        close(scores, port(m).decision_function(_queries(n=3, seed=s)).numpy(), SHARED_RTOL)
    assert sorted(results) == list(range(8)) and pe.stats()["requests"] == 8


# --------------------------------------------------------------------- #
# decode, the registry, and a trained model                              #
# --------------------------------------------------------------------- #
def test_ovo_host_decode_matches_both_device_votes():
    from repro.core.multiclass import ovo_vote as jovo
    from repro.serve.engine import _ovo_vote_np as j_np
    from repro_torch.core.multiclass import ovo_vote

    r = np.random.default_rng(9)
    pairs = np.array([[a, b] for a in range(4) for b in range(a + 1, 4)], np.int32)
    scores = r.normal(size=(50, pairs.shape[0])).astype(np.float32)
    scores[0] = 0.0
    scores[1, :] = 1e-6
    host = _ovo_vote_np(scores, pairs, 4)
    assert np.array_equal(host, j_np(scores, pairs, 4))
    assert np.array_equal(host, np.asarray(jovo(jnp.asarray(scores), pairs, 4)))
    assert np.array_equal(host, ovo_vote(torch.as_tensor(scores), pairs, 4).numpy())


def test_registry_round_trip_serves_the_same(tmp_path):
    jm = mk_jax_model("ovo", seed=6)
    pm = port(jm)
    ModelRegistry(tmp_path / "port").save("m", pm)
    JRegistry(str(tmp_path / "jax")).save("m", jm)
    pe = ServingEngine(registry=ModelRegistry(tmp_path / "port"), device="cpu")
    je = JEngine(registry=JRegistry(str(tmp_path / "jax")))
    pid, jid = pe.load("m"), je.load("m")
    assert pid == jid == "m@v1"
    xq = _queries()
    (ps, pp), (js, jp) = pe.score(pid, xq), je.score(jid, xq)
    assert np.array_equal(ps, pm.decision_function(xq).numpy())
    close(ps, js, F32_RTOL)
    assert np.array_equal(pp, jp)
    same_stats(je, pe)


def test_jax_trained_models_served_by_both_engines():
    """The slice end to end: a JAX engine trains on 512 points (a warm C
    sweep: three models of one factorization), the port serves them."""
    from repro.core.compression import CompressionParams
    from repro.core.engine import HSSSVMEngine
    from repro.data import synthetic

    x, y, xte, _ = synthetic.train_test("blobs", 512, 96, seed=2, n_features=4, sep=2.0)
    eng = HSSSVMEngine(spec=JSpec(h=1.2), comp=CompressionParams(rank=12, n_near=16,
                                                                  n_far=24),
                       leaf_size=256, max_it=10)
    eng.prepare(x, y)
    jms = eng.train_grid([0.5, 1.0, 2.0])
    je, pe = engines(dict(buckets=(32, 128)))
    jids = [je.add_model(m) for m in jms]
    pids = [pe.add_model(port(m)) for m in jms]
    assert pe.stats()["groups"] == 1
    reqs = [(k % 3, xte[8 * k:8 * k + 8]) for k in range(12)]
    jt = [je.submit(jids[i], q) for i, q in reqs]
    pt = [pe.submit(pids[i], q) for i, q in reqs]
    je.flush(), pe.flush()
    same_stats(je, pe)
    assert pe.stats()["launches"] == 1 and pe.stats()["support_uploads"] == 1
    for (i, q), a, b in zip(reqs, jt, pt):
        (js, jp), (ps, pp) = a.result(timeout=0), b.result(timeout=0)
        close(ps, js, F32_RTOL)
        assert np.array_equal(pp, jp)
        assert np.array_equal(pp, np.asarray(jms[i].predict(jnp.asarray(q))))
