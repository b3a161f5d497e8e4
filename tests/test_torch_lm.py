"""The port's LM serving path (ssm / hybrid families) against the JAX package.

The other families are held in ``tests/test_torch_lm_families.py`` and
``tests/test_torch_moe.py``.

The same inputs, made with numpy from a seed, go through both packages; JAX
parameters reach the port through ``repro_torch.convert.lm_params_from_numpy``.
The Pallas kernels run as the JAX package's own tests run them, with
``interpret=True``.  On the CPU the port's wrappers run the plain versions
of K5 and K6, which these tests hold against the reference.

Tolerances, with their reasons:
  - K5's plain version: 2e-4, the JAX attention test's own (f32 softmax
    sums in another order); bf16 inputs 1e-2, about two bf16 rounding steps
    of the output, which both sides round once from f32.
  - K6's plain version: 1e-4 relative, 1e-5 absolute, the JAX SSD test's.
  - Blocks and whole models in f32: 1e-4 of the largest |value|; the two
    agree to ~1e-6 (f32 reductions in another order through a few layers).
  - Whole models in bf16: 5e-2 of the largest |logit|.  bf16 rounds at other
    places in the two frameworks; on this input the JAX package's own bf16
    prefill differs from its f32 prefill by 1.7e-2 of the largest |logit|.
    That noise hides how the f32 SSM scalars are rounded, so the bf16
    weights are held bit for bit against ``_cast_tree`` on their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config, list_archs as jlist_archs
from repro.kernels.attention import ops as jattn_ops
from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jssd_ref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.transformer import Model as JModel, _cast_tree
from repro_torch import convert
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import Model
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ["zamba2-1.2b", "mamba2-780m"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rel):
    """|got - want| <= rel * max |want| (a tolerance relative to the scale)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# --------------------------------------------------------------------- #
# K5: attention                                                         #
# --------------------------------------------------------------------- #
def _qkv(b=1, h=4, hkv=2, s=128, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * 0.5).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))


ATTN_OPTIONS = [
    dict(causal=True, window=None, softcap=0.0),
    dict(causal=True, window=32, softcap=0.0),
    dict(causal=True, window=None, softcap=30.0),
    dict(causal=False, window=None, softcap=0.0),   # encoder (hubert)
    dict(causal=True, window=16, softcap=50.0),     # gemma2-style local
]


@pytest.mark.parametrize("opts", ATTN_OPTIONS)
def test_attention_plain_matches_jax_ref_and_pallas(opts):
    q, k, v = _qkv()
    out = attn_ops.flash_attention(_t(q), _t(k), _t(v), **opts).numpy()
    want_ref = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **opts)
    want_pallas = jattn_ops.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), interpret=True, **opts)
    np.testing.assert_allclose(out, np.asarray(want_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, np.asarray(want_pallas), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [
    dict(b=2, h=2, hkv=1, s=64, d=16),    # MQA
    dict(b=1, h=8, hkv=8, s=64, d=64),    # MHA
    dict(b=1, h=6, hkv=2, s=96, d=32),    # GQA, non-pow2 seq
])
def test_attention_plain_gqa_shapes(shape):
    q, k, v = _qkv(**shape)
    out = attn_ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    want_ref = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    want_pallas = jattn_ops.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True, interpret=True)
    np.testing.assert_allclose(out, np.asarray(want_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, np.asarray(want_pallas), rtol=2e-4, atol=2e-4)


def test_attention_plain_bf16_matches_pallas():
    q, k, v = (a.astype(jnp.bfloat16) for a in map(jnp.asarray, _qkv()))
    out = attn_ops.flash_attention(*(torch.from_numpy(np.asarray(a, np.float32))
                                     .to(torch.bfloat16) for a in (q, k, v)),
                                   causal=True, window=32)
    assert out.dtype == torch.bfloat16
    want = jattn_ops.fused_attention(q, k, v, causal=True, window=32, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("causal,window,prefix_len", [
    (True, 8, 5), (True, 0, 12), (False, 8, 3), (True, 24, 0)])
def test_attention_plain_matches_chunked_attention(causal, window, prefix_len):
    """The model path's semantics: the layer window and prefix keys that
    every query sees (chunked over several q and kv chunks on the JAX side)."""
    q, k, v = _qkv(b=2, h=4, hkv=2, s=48, d=16, seed=3)
    out = attn_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                                   prefix_len=prefix_len).numpy()
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want = jlayers.chunked_attention(tr(q), tr(k), tr(v), causal=causal, window=window,
                                     prefix_len=prefix_len, chunk_q=16, chunk_kv=8)
    np.testing.assert_allclose(out, np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------- #
# K6: the SSD chunk scan                                                #
# --------------------------------------------------------------------- #
def _ssd_inputs(b=2, s=64, h=4, p=16, g=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            (np.abs(rng.normal(size=(b, s, h))) * 0.1 + 0.01).astype(f),
            (-np.abs(rng.normal(size=h)) - 0.1).astype(f),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(f),
            (rng.normal(size=(b, s, g, n)) * 0.3).astype(f),
            (rng.normal(size=h) * 0.1).astype(f))


@pytest.mark.parametrize("shape", [
    dict(b=2, s=64, h=4, p=16, g=2, n=8, chunk=16),
    dict(b=1, s=96, h=6, p=8, g=3, n=16, chunk=32),
    dict(b=1, s=32, h=2, p=8, g=1, n=4, chunk=32),      # one chunk
])
def test_ssd_plain_matches_pallas_and_state_ref(shape):
    shape = dict(shape)
    chunk = shape.pop("chunk")
    args = _ssd_inputs(**shape)
    y, h_fin = ssd_ops.ssd_forward(*map(_t, args), chunk=chunk, return_state=True)
    y_only = ssd_ops.ssd_forward(*map(_t, args), chunk=chunk)
    jargs = tuple(map(jnp.asarray, args))
    y_pallas = jssd_ops.ssd_forward(*jargs, chunk=chunk, interpret=True, use_pallas=True)
    y_ref, h_ref = jssd_ref.ssd_batched_with_state(*jargs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_fin.numpy(), np.asarray(h_ref), rtol=1e-4, atol=1e-5)
    assert torch.equal(y, y_only)


def test_ssd_plain_matches_the_exact_recurrence():
    """One head of the chunked scan against ``ssd_scan_ref``'s recurrence."""
    x, dt, a, b_mat, c_mat, d_vec = _ssd_inputs(b=1, s=64, h=1, p=8, g=1, n=4, seed=5)
    y, h_fin = ssd_ops.ssd_forward(*map(_t, (x, dt, a, b_mat, c_mat, d_vec)), chunk=16,
                                   return_state=True)
    y_scan, h_scan = jssd_ref.ssd_scan_ref(jnp.asarray(x[0, :, 0]), jnp.asarray(dt[0, :, 0]),
                                           float(a[0]), jnp.asarray(b_mat[0, :, 0]),
                                           jnp.asarray(c_mat[0, :, 0]), float(d_vec[0]))
    np.testing.assert_allclose(y[0, :, 0].numpy(), np.asarray(y_scan), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_fin[0, 0].numpy(), np.asarray(h_scan), rtol=1e-4, atol=1e-5)


def test_ssd_plain_refuses_a_ragged_sequence():
    with pytest.raises(ValueError):
        ssd_ops.ssd_forward(*map(_t, _ssd_inputs(s=40)), chunk=16)


# --------------------------------------------------------------------- #
# blocks                                                                #
# --------------------------------------------------------------------- #
def _jax_model(arch, **over):
    cfg = jget_config(arch).reduced(**{"remat": "none", **over})
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return cfg, jm, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("return_cache", [False, True])
def test_ssm_block_matches_jax(return_cache):
    cfg, _, _, npp = _jax_model("zamba2-1.2b", ssd_chunk=16, compute_dtype="float32")
    lp = {k: v[1] for k, v in npp["layers"]["ssm"].items()}        # layer 1
    x = (np.random.default_rng(2).normal(size=(2, 48, cfg.d_model)) * 0.5).astype(np.float32)
    want = jssm.ssm_block(jnp.asarray(x), jssm.SSMParams(**lp), cfg, return_cache=return_cache)
    tcfg = get_config("zamba2-1.2b").reduced(remat="none", ssd_chunk=16,
                                             compute_dtype="float32")
    got = ssm.ssm_block(_t(x), ssm.SSMParams(**{k: _t(v) for k, v in lp.items()}), tcfg,
                        return_cache=return_cache)
    if not return_cache:
        _close(got.numpy(), want, 1e-4)
        return
    _close(got[0].numpy(), want[0], 1e-4)
    _close(got[1].conv.numpy(), want[1].conv, 1e-6)
    _close(got[1].state.numpy(), want[1].state, 1e-4)


@pytest.mark.parametrize("window,prefix_len", [(0, 0), (8, 0), (8, 6)])
def test_attention_block_matches_jax(window, prefix_len):
    cfg, _, _, npp = _jax_model("zamba2-1.2b", compute_dtype="float32")
    ap = npp["shared"]["attn"]
    x = (np.random.default_rng(4).normal(size=(2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = jlayers.attention_block(jnp.asarray(x), jlayers.AttnParams(**ap),
                                   jnp.asarray(pos), cfg, window, prefix_len)
    tcfg = get_config("zamba2-1.2b").reduced(remat="none", compute_dtype="float32")
    got = layers.attention_block(_t(x), layers.AttnParams(**{k: _t(v) for k, v in ap.items()}),
                                 _t(pos), tcfg, window, prefix_len)
    _close(got.numpy(), want, 1e-4)


# --------------------------------------------------------------------- #
# the slice: prefill + teacher-forced decode                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("compute_dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch, compute_dtype, rel):
    """4 layers and chunk 16 with a 64-token prompt: the state crosses
    chunks and zamba2 applies its shared block twice (every 2 layers)."""
    over = dict(n_layers=4, ssd_chunk=16, compute_dtype=compute_dtype)
    cfg, jm, params, npp = _jax_model(arch, **over)
    tcfg = get_config(arch).reduced(remat="none", **over)
    tm = convert.lm_params_from_numpy(tcfg, npp, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 68))
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :64], jnp.int32)}, 72)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :64])}, 72)
    _close(tl.numpy(), jl, rel)
    _close(tc["ssm_state"].numpy(), jc["ssm_state"], rel)
    if arch == "zamba2-1.2b":
        _close(tc["shared_k"].float().numpy(), np.asarray(jc["shared_k"], np.float32), rel)
    for i in range(64, 68):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        tl, tc = tm.decode_step(tc, torch.as_tensor(toks[:, i:i + 1]))
        _close(tl.numpy(), jl, rel)
    assert tc["pos"] == int(jc["pos"]) == 68


def test_compute_weights_round_like_cast_tree():
    """Every float parameter enters the bf16 compute rounded to bf16, the
    f32 ``a_log``/``d_skip``/``dt_bias`` included, bit for bit as the
    reference's ``_cast_tree`` rounds them.  (End to end the bf16 models
    agree only to bf16 noise, which does not show this rounding.)"""
    cfg, _, params, npp = _jax_model("zamba2-1.2b", n_layers=2)
    tm = convert.lm_params_from_numpy(get_config("zamba2-1.2b").reduced(
        remat="none", n_layers=2), npp, device="cpu")
    w = tm.weights()
    cd = jnp.bfloat16
    for idx, (ln1, p) in enumerate(w.layers):
        want = _cast_tree(jax.tree.map(lambda a: a[idx], params["layers"]), cd)
        assert np.array_equal(ln1.float().numpy(), np.asarray(want["ln1"], np.float32))
        for name, got in p._asdict().items():
            assert got.dtype == torch.bfloat16, name
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(want["ssm"][name], np.float32)), name
    want = _cast_tree(params["shared"], cd)
    for name, got in w.shared.attn._asdict().items():
        assert np.array_equal(got.float().numpy(), np.asarray(want["attn"][name], np.float32))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """prefill(s tokens) + decode == forward(s + 1 tokens), on the port
    alone (the tolerances of ``tests/test_configs_smoke.py``, bf16 compute)."""
    cfg = get_config(arch).reduced(remat="none")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 16), generator=torch.Generator().manual_seed(3))
    logits_pre, cache = model.prefill({"tokens": tokens}, max_len=20)
    full = model.forward_logits({"tokens": tokens})
    np.testing.assert_allclose(logits_pre.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)
    nxt = logits_pre.argmax(-1)[:, None]
    logits_dec, _ = model.decode_step(cache, nxt)
    full2 = model.forward_logits({"tokens": torch.cat([tokens, nxt], dim=1)})
    np.testing.assert_allclose(logits_dec.numpy(), full2[:, -1].numpy(), rtol=5e-2, atol=5e-2)


# --------------------------------------------------------------------- #
# configs, families, entry point                                        #
# --------------------------------------------------------------------- #
def test_every_arch_resolves_to_the_reference_config():
    assert list_archs() == jlist_archs()
    for arch in list_archs():
        assert get_config(arch).__dict__ == jget_config(arch).__dict__, arch
        assert get_config(arch).reduced().__dict__ == jget_config(arch).reduced().__dict__


def test_init_draws_the_reference_distributions():
    cfg = get_config("zamba2-1.2b").reduced(d_model=128)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    lay = m.layers[0]
    assert abs(float(m.embed.std()) - 0.02) < 2e-3
    assert abs(float(lay.in_proj.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    np.testing.assert_allclose(lay.a_log.numpy(),
                               np.log(np.linspace(1.0, 16.0, cfg.ssm_heads)), rtol=1e-6)
    dt0 = torch.nn.functional.softplus(lay.dt_bias.double())
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5) and float(dt0.max()) <= 1e-1 * (1 + 1e-5)
    assert float(lay.d_skip.min()) == float(lay.d_skip.max()) == 1.0
    assert float(m.shared.ln1.abs().max()) == 0.0


def test_serve_tiny_on_cpu(capsys):
    out = serve.serve_lm(serve.parser().parse_args(
        ["--arch", "zamba2-1.2b", "--preset", "tiny", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "3"]))
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["last_logits"]).all()
    printed = capsys.readouterr().out
    assert "prefill: 2x16" in printed and "tok/s" in printed
