"""Serving a model sharded over a mesh: prefill and decode on gloo ranks on
the CPU against the JAX package's single-device ``Model.prefill`` /
``decode_step``.

``dist.api.spawn`` starts 2 ranks on a ("data", "model") mesh (1, 2) and 4
on (2, 2), once each, while this process builds the references; each rank
runs ``tests/torch_serve_mesh_ranks.py`` on a model drawn by the same
seeded ``Model.init`` (``convert.lm_params_to_numpy`` hands the same
parameters to the JAX package).  Reduced configs, 2 layers, f32, a prompt
of 24 tokens and 4 teacher-forced decode steps:

  * granite with 12 experts (padded to 16: rank 1 holds four real ones) at
    capacity factor 6 = E / top_k, where every expert takes all of a
    chunk's tokens: no token drops on one device or on a data shard, so the
    mesh's function (each data shard routes its own tokens) is the
    single-device one;
  * zamba2 with ``shared_attn_every=2`` (SSM blocks whole on every rank,
    the state's 8 heads 4 a rank; the shared attention head-parallel);
  * gemma2 with a window of 8 (shorter than the prompt) and its softcaps;
  * paligemma (one kv head: the plan replicates the K/V cache, each rank
    reads its slice of it);
  * gemma2 again with the attention forced onto the reference's fallback
    (every head on every rank) while the plan splits the cache's kv heads:
    prefill stores the rank's heads, decode gathers the cache for the
    layer.  With kv heads dividing the query heads, the plan splits them
    only where mp divides kvh, and then the head-parallel split applies, so
    no configuration reaches this pairing by itself: the case forces it.

Each at (1, 2); granite and zamba2 at (2, 2) too, batch 4 (2 a data shard).
The rank's prefill and decode logits (its data shard's rows, whole over the
vocabulary: the head is vocab-split and gathered) within 1e-4 of the
largest |logit| of the reference's (f32 sums in another order, as
tests/test_torch_lm_mesh.py), and each rank's cache leaf after prefill and
after the last step equal to the reference's cache sliced at the
reference's ``cache_shardings`` spec on ``AbstractMesh`` (1e-5 of the
leaf's largest |value|, at least 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import torch_dist_ranks as dist_ranks
import torch_serve_mesh_ranks as ranks
from repro.configs.registry import get_config as jget_config
from repro.dist import sharding as jshard
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.dist import api as dist_api
from torch_lm_mesh_ranks import model_of
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
GRANITE = ("granite-moe-3b-a800m", dict(F32, n_experts=12, capacity_factor=6.0))
ZAMBA = ("zamba2-1.2b", dict(F32, shared_attn_every=2))
GEMMA = ("gemma2-9b", dict(F32, window=8))
PALI = ("paligemma-3b", F32)
PROMPT, STEPS = 24, 4
LOGIT_RTOL, CACHE_RTOL = 1e-4, 1e-5
# (name, (arch, overrides), batch, fallback) per world size
TWO = [("granite", GRANITE, 2, False), ("zamba2", ZAMBA, 2, False),
       ("gemma2", GEMMA, 2, False), ("paligemma", PALI, 2, False),
       ("gemma2-fallback", GEMMA, 2, True)]
FOUR = [("granite", GRANITE, 4, False), ("zamba2", ZAMBA, 4, False)]
MESHES = {2: (1, 2), 4: (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with dist_ranks.torch_threads(1):
        yield


def _inputs(arch, over, b):
    """numpy inputs: the prompt's batch, the decode steps' tokens, max_len."""
    cfg = get_config(arch).reduced(**over)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(b, PROMPT + STEPS))
    batch = {"tokens": toks[:, :PROMPT]}
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.normal(size=(b, cfg.n_prefix_tokens,
                                            cfg.frontend_dim)).astype(np.float32)
    return batch, toks[:, PROMPT:], PROMPT + STEPS + cfg.n_prefix_tokens


def _reference(arch, over, b, mesh_shape):
    """The JAX package's single-device prefill and teacher-forced decode of
    the seeded model: logits and the cache after each."""
    batch, steps, max_len = _inputs(arch, over, b)
    jm = JModel(jget_config(arch).reduced(**over))
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(model_of(arch, over)))
    logits, cache = jax.jit(jm.prefill, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, max_len)
    out = dict(prefill=np.asarray(logits), cache_prefill=jax.tree.map(np.asarray, cache),
               decode=[])
    decode = jax.jit(jm.decode_step)
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(steps[:, i:i + 1], jnp.int32))
        out["decode"].append(np.asarray(logits))
    out["cache"] = jax.tree.map(np.asarray, cache)
    out["decode"] = np.stack(out["decode"])
    out["specs"] = {k: tuple(s.spec) for k, s in jshard.cache_shardings(
        jax.eval_shape(lambda: cache), AbstractMesh(mesh_shape, ("data", "model")),
        batch=b).items()}
    return out


@pytest.fixture(scope="module")
def runs():
    """Both worlds spawned at once; meanwhile the references."""
    joins = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        args = [(arch, over, *_inputs(arch, over, b), fb) for _, (arch, over), b, fb in cases]
        joins[world] = dist_ranks.in_background(
            dist_api.spawn, ranks.world, world, args, mesh_shape=MESHES[world],
            mesh_names=("data", "model"))
    refs = {}
    for world, cases in ((2, TWO), (4, FOUR)):
        for _, (arch, over), b, _ in cases:
            if (arch, b) not in refs:
                refs[(arch, b)] = _reference(arch, over, b, MESHES[world])
    return refs, {w: join() for w, join in joins.items()}


def _close(got, want, rtol):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1.0) if rtol == CACHE_RTOL else np.abs(want).max()
    assert err <= rtol * scale, (err, scale)


def _part(a, spec, coords, mesh_shape):
    """The reference's leaf ``a`` cut at ``spec`` for the rank at ``coords``
    (its data and model index)."""
    idx = []
    for dim, entry in zip(a.shape, tuple(spec) + (None,) * (a.ndim - len(spec))):
        if entry is None:
            idx.append(slice(None))
            continue
        axis = 0 if entry == "data" else 1
        per = dim // mesh_shape[axis]
        idx.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return a[tuple(idx)]


CASES = [(2, i, name) for i, (name, *_) in enumerate(TWO)] + \
        [(4, i, name) for i, (name, *_) in enumerate(FOUR)]


@pytest.mark.parametrize("world,case,name", CASES,
                         ids=[f"{n}-{MESHES[w][0]}x{MESHES[w][1]}" for w, _, n in CASES])
def test_sharded_serving_matches_jax(runs, world, case, name):
    refs, outs = runs
    _, (arch, over), b, fallback = (TWO if world == 2 else FOUR)[case]
    ref = refs[(arch, b)]
    cfg = get_config(arch).reduced(**over)
    mesh_shape = MESHES[world]
    b_loc = b // mesh_shape[0]
    for o in outs[world]:
        r = o[case]
        d, m = r["coords"]
        rows = slice(d * b_loc, (d + 1) * b_loc)
        assert tuple(r["prefill"].shape) == (b_loc, cfg.vocab)
        assert np.abs(r["prefill"].numpy() - ref["prefill"][rows]).max() <= \
            LOGIT_RTOL * np.abs(ref["prefill"]).max()
        assert np.abs(r["decode"].numpy() - ref["decode"][:, rows]).max() <= \
            LOGIT_RTOL * np.abs(ref["decode"]).max()
        assert r["pos"] == PROMPT + STEPS + cfg.n_prefix_tokens
        for when in ("cache_prefill", "cache"):
            assert set(r[when]) == set(ref[when]) - {"pos"}
            for key, got in r[when].items():
                want = _part(ref[when][key], ref["specs"][key], (d, m), mesh_shape)
                _close(got, want, CACHE_RTOL)
        # the plan's placements, as the rank holds them
        if cfg.family in ("hybrid",):
            assert r["cache"]["ssm_state"].shape[2] == cfg.ssm_heads // mesh_shape[1]
            assert r["cache"]["shared_k"].shape[3] == cfg.n_kv_heads // mesh_shape[1]
        elif cfg.n_kv_heads % mesh_shape[1] == 0:
            assert r["cache"]["k"].shape[3] == cfg.n_kv_heads // mesh_shape[1]
        else:
            assert r["cache"]["k"].shape[3] == cfg.n_kv_heads        # replicated
        assert r["stats"]["all_reduce_calls"] > 0 and r["stats"]["all_gather_calls"] > 0
        # every collective runs in a group of 2: the ring model moves 2·(n-1)/n
        # of an all-reduce's bytes and (n-1) times a gather's shard, both x1
        assert r["ring"]["all_reduce"] == r["stats"]["all_reduce_bytes"]
        assert r["ring"]["all_gather"] == r["stats"]["all_gather_bytes"]
        if fallback:
            # the split cache gathered once a layer and step
            assert r["stats"]["all_gather_calls"] >= 2 * cfg.n_layers * STEPS
