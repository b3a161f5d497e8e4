"""The port's MoE (``layers.moe_block``) and moe-family models against the JAX package.

``moe_block`` is held against the reference's single-device branch
(``repro.models.layers.moe_block`` outside a mesh) on the same numpy
inputs: its output and the Switch aux loss, with a case whose capacity
overflows (so the dropped choices must be the reference's) and one whose
gates tie exactly (lax.top_k takes the lower expert first).  Tolerances:
f32 1e-5 relative (f32 sums in another order); bf16 compute 2e-2 of the
largest |value| (the f32 expert products sum in other orders, and one
ulp may move a bf16 router logit past another).  The combine itself, which
adds each token's k rows in the reference's order with no atomics, is
held bit for bit against the reference's scatter on the same rows, and the
expert counts (a scatter of ones, no host read on the card) against
bincount.

granite-moe-3b-a800m and arctic-480b (its parallel dense FFN) are then held
as ``tests/test_torch_lm_families.py`` holds the dense family: prefill,
cache, four decode steps and ``forward_logits`` at 4 layers, f32 to 1e-4
and bf16 to 5e-2 of the largest |value|.  Routing is not continuous: in
bf16 a router logit has 8 bits, and one bf16 step of difference upstream
(which the two frameworks' attention already shows) moves a token to
another expert among near-equal gates.  The JAX package's own bf16 forward
of granite's reduced config differs from its f32 forward by 0.42 of the
largest |logit| (against 1.5e-2 for llama3's).  So the bf16 models route
every token to every expert (``top_k = n_experts``, where the function is
continuous); top-k selection, capacity and ties in bf16 are held at the
block above, on identical inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.configs.registry import get_config
from repro_torch.models import layers
from repro_torch.models.transformer import Model
from test_torch_lm_families import DTYPES, _close, runs
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _moe_inputs(b, s, d, e, ff, seed=0, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    shapes = [(d, e), (e, d, ff), (e, d, ff), (e, ff, d)]
    p = [(rng.normal(size=sh) * sh[-2] ** -0.5).astype(np.float32) for sh in shapes]
    if tie:                       # experts 1 and 2 get equal logits on every token
        p[0][:, 2] = p[0][:, 1]
    return x, p


_jmoe = jax.jit(jlayers.moe_block, static_argnums=(2, 3))


def _both(x, p, top_k, cf, dtype):
    jout, jaux = _jmoe(jnp.asarray(x, _JDT[dtype]),
                       jlayers.MoEParams(*(jnp.asarray(a, _JDT[dtype]) for a in p)), top_k, cf)
    tout, taux = layers.moe_block(torch.as_tensor(x).to(_TDT[dtype]),
                                  layers.MoEParams(*(torch.as_tensor(a).to(_TDT[dtype])
                                                     for a in p)), top_k, cf)
    assert tout.dtype == _TDT[dtype] and taux.dtype == torch.float32
    return (np.asarray(jout, np.float32), float(jaux)), (tout.float().numpy(), float(taux))


def _dropped(x, p, top_k, cf):
    """How many (token, expert) choices the reference's capacity drops."""
    t = x.shape[0] * x.shape[1]
    e = p[0].shape[1]
    logits = x.reshape(t, -1) @ p[0]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :top_k]
    cap = min(int(max(4, (t * top_k / e) * cf)), t)
    return int(np.maximum(np.bincount(idx.ravel(), minlength=e) - cap, 0).sum())


MOE_CASES = [
    # (B, S, d, E, ff, top_k, capacity_factor)
    (2, 32, 32, 4, 48, 2, 0.5),        # 64 tokens: capacity 32 a expert, overflows
    (2, 32, 32, 4, 48, 2, 1.25),
    (1, 48, 24, 40, 16, 8, 1.25),      # granite's 40 experts, top-8 (the reference pads to 48)
    (3, 1, 32, 4, 48, 2, 1.25),        # a decode step: 3 tokens, cap min(4, 3)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_jax(case, dtype):
    b, s, d, e, ff, k, cf = case
    x, p = _moe_inputs(b, s, d, e, ff)
    if cf < 1:
        assert _dropped(x, p, k, cf) > 0
    (jout, jaux), (tout, taux) = _both(x, p, k, cf, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5 * np.abs(jout).max())
        assert taux == pytest.approx(jaux, rel=1e-5)
    else:
        _close(tout, jout, 2e-2)
        assert taux == pytest.approx(jaux, rel=2e-2)


def test_overflow_drops_the_references_choices():
    """Which tokens lose all their experts to the capacity is exact: the
    stable sort by expert keeps the earliest tokens."""
    x, p = _moe_inputs(2, 32, 32, 4, 48)
    (jout, _), (tout, _) = _both(x, p, 2, 0.5, "float32")
    j_zero = np.abs(jout).max(-1) == 0
    assert j_zero.any()
    np.testing.assert_array_equal(np.abs(tout).max(-1) == 0, j_zero)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equal_gates_take_the_lower_expert_first(dtype):
    """Experts 1 and 2 tie on every token; top-1 must pick expert 1 wherever
    they lead, as lax.top_k does."""
    x, p = _moe_inputs(2, 16, 32, 4, 48, seed=2, tie=True)
    (jout, jaux), (tout, taux) = _both(x, p, 1, 4.0, dtype)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5 * np.abs(jout).max())
    assert taux == pytest.approx(jaux, rel=1e-5 if dtype == "float32" else 2e-2)


def test_combine_adds_in_the_references_order():
    """bf16 rows of 96 tokens, top 8 of 40 experts (each expert chosen by
    many tokens): the combine equals the reference's ``.at[st].add`` bit
    for bit, where the reversed order already differs.  So does not the
    combine it replaces: ``index_add_`` on the CPU sums a token's bf16 rows
    in f32 and rounds once (on the card, with atomics in any order)."""
    rng = np.random.default_rng(5)
    t, k, e, d = 96, 8, 40, 64
    gate_idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    order = np.argsort(gate_idx.reshape(-1), kind="stable")
    st = np.repeat(np.arange(t), k)[order]
    rows = (rng.normal(size=(t * k, d)) * np.exp(rng.normal(size=(t * k, 1)) * 2)
            ).astype(np.float32)
    want = np.asarray(jnp.zeros((t, d), jnp.bfloat16).at[st].add(jnp.asarray(rows, jnp.bfloat16))
                      .astype(jnp.float32))
    trows = torch.as_tensor(rows).to(torch.bfloat16)
    got = layers.combine_top_k(trows, torch.as_tensor(order), torch.as_tensor(gate_idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    old = torch.zeros((t, d), dtype=torch.bfloat16).index_add_(0, torch.as_tensor(st), trows)
    assert not torch.equal(got, old)
    rev = torch.zeros((t, d), dtype=torch.bfloat16).index_add_(
        0, torch.as_tensor(st[::-1].copy()), trows.flip(0))
    assert not torch.equal(got, rev)


def test_expert_counts_equal_bincount():
    idx = torch.as_tensor(np.random.default_rng(6).integers(0, 40, size=3000))
    for dtype in (torch.float32, torch.long):
        got = layers.expert_counts(idx, 48, dtype)
        assert got.dtype == dtype
        assert torch.equal(got.long(), torch.bincount(idx, minlength=48))


# --------------------------------------------------------------------- #
# the moe family's models                                               #
# --------------------------------------------------------------------- #
MOE_ARCHS = ["granite-moe-3b-a800m", "arctic-480b"]


def _moe_runs(arch, compute_dtype):
    over = {} if compute_dtype == "float32" else {"top_k": 4}   # reduced: 4 experts
    return runs(arch, compute_dtype, **over)


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_jax(arch, compute_dtype, rel):
    r = _moe_runs(arch, compute_dtype)
    for name in ("prefill", "k", "v"):
        _close(r["port"][name], r["jax"][name], rel)


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_jax(arch, compute_dtype, rel):
    r = _moe_runs(arch, compute_dtype)
    for got, want in zip(r["port"]["decode"], r["jax"]["decode"], strict=True):
        _close(got, want, rel)
    _close(r["port"]["k_end"], r["jax"]["k_end"], rel)


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_match_jax(arch, compute_dtype, rel):
    r = _moe_runs(arch, compute_dtype)
    _close(r["port"]["forward"], r["jax"]["forward"], rel)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_decode_matches_forward(arch):
    """prefill + decode == forward on the port alone, f32, with a capacity
    that drops nothing (decode routes B tokens under its own capacity, the
    forward B * (s + 1) under another)."""
    cfg = get_config(arch).reduced(remat="none", compute_dtype="float32", capacity_factor=2.0)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(3))
    logits_pre, cache = model.prefill({"tokens": tokens}, max_len=25)
    _close(logits_pre.numpy(), model.forward_logits({"tokens": tokens})[:, -1].numpy(), 1e-4)
    nxt = logits_pre.argmax(-1)[:, None]
    logits_dec, _ = model.decode_step(cache, nxt)
    full = model.forward_logits({"tokens": torch.cat([tokens, nxt], dim=1)})
    _close(logits_dec.numpy(), full[:, -1].numpy(), 1e-4)
