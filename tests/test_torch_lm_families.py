"""The port's attention families (dense, vlm, encoder) against the JAX package.

Reduced configs at 4 layers (window 16, so gemma2's even layers are local
and the 64-token prompt runs past the window).  JAX parameters from
``Model.init`` reach the port through ``repro_torch.convert
.lm_params_from_numpy``; the inputs are made with numpy from a seed.  Each
arch is held on a prefill of the prompt (logits and the K/V cache), four
teacher-forced decode steps, and ``forward_logits`` (hubert: frames with
``mask_indices``, no decode step, as in the reference); the moe family's
models are held the same way in ``tests/test_torch_moe.py``.

Tolerances, of the largest |value|, with their reasons
(``tests/test_torch_lm.py``'s): f32 1e-4 (the two agree to ~1e-6, f32
reductions in another order through 4 layers); bf16 5e-2 (bf16 rounds at
other places in the two frameworks: ~1e-2 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma2-9b", "llama3-405b", "paligemma-3b", "hubert-xlarge"]
DTYPES = [("float32", 1e-4), ("bfloat16", 5e-2)]
BATCH, PROMPT, STEPS = 2, 64, 4
_RUNS: dict = {}


def _close(got, want, rel):
    """|got - want| <= rel * max |want| (a tolerance relative to the scale)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _np(a) -> np.ndarray:
    """A JAX array or a torch tensor as f32 numpy (a copy: decode writes
    the port's cache in place)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32, copy=True).numpy()
    return np.asarray(a, np.float32)


def _inputs(cfg, seed=1):
    """numpy inputs: ``tokens`` (B, PROMPT + STEPS); vlm ``patches``; audio
    ``frames`` and ``mask_indices`` of the prompt's length."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(BATCH, PROMPT + STEPS))}
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.normal(size=(BATCH, cfg.n_prefix_tokens,
                                          cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        out["frames"] = rng.normal(size=(BATCH, PROMPT, cfg.frontend_dim)).astype(np.float32)
        out["mask_indices"] = rng.random((BATCH, PROMPT)) < 0.3
    return out


def _batch(inp, to):
    """The prompt's batch for one package (``to`` converts a numpy array)."""
    if "frames" in inp:
        return {"frames": to(inp["frames"]), "mask_indices": to(inp["mask_indices"])}
    batch = {"tokens": to(inp["tokens"][:, :PROMPT])}
    if "patches" in inp:
        batch["patches"] = to(inp["patches"])
    return batch


def runs(arch, compute_dtype, **over):
    """Both packages on the same parameters and inputs, once per case:
    {"jax"|"port": {"forward", "prefill", "k", "v", "decode", "k_end"}}."""
    key = (arch, compute_dtype, tuple(sorted(over.items())))
    if key in _RUNS:
        return _RUNS[key]
    over = dict(n_layers=4, remat="none", compute_dtype=compute_dtype, **over)
    cfg = jget_config(arch).reduced(**over)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = convert.lm_params_from_numpy(get_config(arch).reduced(**over),
                                      jax.tree.map(np.asarray, params), device="cpu")
    inp = _inputs(cfg)
    jb = _batch(inp, jnp.asarray)
    tb = _batch(inp, torch.as_tensor)
    out = {"jax": {"forward": _np(jax.jit(jm.forward_logits)(params, jb))},
           "port": {"forward": _np(tm.forward_logits(tb))}}
    if cfg.is_decoder:
        max_len = PROMPT + STEPS + cfg.n_prefix_tokens
        decode = jax.jit(jm.decode_step)
        jl, jc = jax.jit(jm.prefill, static_argnums=2)(params, jb, max_len)
        tl, tc = tm.prefill(tb, max_len)
        for side, logits, cache in (("jax", jl, jc), ("port", tl, tc)):
            out[side].update(prefill=_np(logits), k=_np(cache["k"]), v=_np(cache["v"]),
                             decode=[])
        for i in range(PROMPT, PROMPT + STEPS):
            step = inp["tokens"][:, i:i + 1]
            jl, jc = decode(params, jc, jnp.asarray(step, jnp.int32))
            tl, tc = tm.decode_step(tc, torch.as_tensor(step))
            out["jax"]["decode"].append(_np(jl))
            out["port"]["decode"].append(_np(tl))
        out["jax"]["k_end"], out["port"]["k_end"] = _np(jc["k"]), _np(tc["k"])
        out["pos"] = (int(jc["pos"]), tc["pos"])
    _RUNS[key] = out
    return out


DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_matches_jax(arch, compute_dtype, rel):
    """The last position's logits and every layer's K/V cache."""
    r = runs(arch, compute_dtype)
    for name in ("prefill", "k", "v"):
        _close(r["port"][name], r["jax"][name], rel)


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_jax(arch, compute_dtype, rel):
    """Four teacher-forced steps: logits, then the cache they wrote."""
    r = runs(arch, compute_dtype)
    for got, want in zip(r["port"]["decode"], r["jax"]["decode"], strict=True):
        _close(got, want, rel)
    _close(r["port"]["k_end"], r["jax"]["k_end"], rel)
    cfg = get_config(arch).reduced()
    assert r["pos"] == (PROMPT + STEPS + cfg.n_prefix_tokens,) * 2


@pytest.mark.parametrize("compute_dtype,rel", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, compute_dtype, rel):
    """Every position (vlm: the patch prefix's too; hubert: masked frames)."""
    r = runs(arch, compute_dtype)
    _close(r["port"]["forward"], r["jax"]["forward"], rel)


# --------------------------------------------------------------------- #
# the port alone                                                        #
# --------------------------------------------------------------------- #
def _port_batch(cfg, n_tokens, seed=3):
    inp = _inputs(cfg, seed)
    batch = {"tokens": torch.as_tensor(inp["tokens"][:, :n_tokens])}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.as_tensor(inp["patches"])
    return batch


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_builds_prefills_decodes_and_runs_forward(arch):
    """All ten configs at ``reduced()``: no family raises; hubert has no
    decode step to serve (``launch.serve`` exits on it, as the reference's)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.frontend == "audio_stub":
        frames = torch.randn((1, 16, cfg.frontend_dim), generator=torch.Generator()
                             .manual_seed(1))
        logits = model.forward_logits({"frames": frames})
        assert logits.shape == (1, 16, cfg.vocab) and torch.isfinite(logits).all()
        with pytest.raises(SystemExit, match="encoder-only"):
            serve.serve_lm(serve.parser().parse_args(
                ["--arch", arch, "--preset", "tiny", "--device", "cpu"]))
        return
    batch = _port_batch(cfg, 16)
    s = 16 + cfg.n_prefix_tokens
    logits, cache = model.prefill(batch, s + 2)
    assert logits.shape == (BATCH, cfg.vocab) and torch.isfinite(logits).all()
    logits, cache = model.decode_step(cache, logits.argmax(-1)[:, None])
    assert torch.isfinite(logits).all() and cache["pos"] == s + 1
    assert model.forward_logits(batch).shape == (BATCH, s, cfg.vocab)


@pytest.mark.parametrize("arch", ["gemma2-9b", "paligemma-3b"])
def test_prefill_decode_matches_forward(arch):
    """prefill(s tokens) + decode == forward(s + 1 tokens), on the port
    alone, in f32: gemma2 with its prompt past the window, paligemma with
    its patch prefix."""
    cfg = get_config(arch).reduced(remat="none", compute_dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _port_batch(cfg, 24)
    s = 24 + cfg.n_prefix_tokens
    logits_pre, cache = model.prefill(batch, max_len=s + 1)
    full = model.forward_logits(batch)
    _close(logits_pre.numpy(), full[:, -1].numpy(), 1e-4)
    nxt = logits_pre.argmax(-1)[:, None]
    logits_dec, _ = model.decode_step(cache, nxt)
    full2 = model.forward_logits(dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1)))
    _close(logits_dec.numpy(), full2[:, -1].numpy(), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """Matrices normal times shape[-2]^-1/2, the embedding and ``mask_emb``
    at 0.02, gains zero: the sample mean and std within 5 standard errors."""
    cfg = get_config(arch).reduced(d_model=128, frontend_dim=96)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mats = [m.head, m.layers[0].wq, m.layers[1].wo, m.layers[0].w_down,
            m.vision_proj, m.frontend_proj]
    draws = [(p, p.shape[-2] ** -0.5) for p in mats if p is not None]
    draws += [(p, 0.02) for p in (m.embed, m.mask_emb) if p is not None]
    for p, scale in draws:
        n = p.numel()
        assert abs(float(p.std()) / scale - 1) < 5 / (2 * n) ** 0.5
        assert abs(float(p.mean())) < 5 * scale / n ** 0.5
    for lay in m.layers:
        assert float(lay.ln1.abs().max()) == float(lay.ln2.abs().max()) == 0.0
    assert float(m.final_norm.abs().max()) == 0.0


def test_layer_windows_alternate_on_gemma2():
    """``_layer_windows``: gemma2 local on the even layers, others uniform."""
    gemma = Model(get_config("gemma2-9b").reduced(n_layers=4), device="cpu")
    assert [gemma.layer_window(i) for i in range(4)] == [16, 0, 16, 0]
    llama = Model(get_config("llama3-405b").reduced(n_layers=2), device="cpu")
    assert [llama.layer_window(i) for i in range(2)] == [0, 0]


@pytest.mark.parametrize("arch", ["gemma2-9b", "paligemma-3b"])
def test_serve_tiny_on_cpu(arch, capsys):
    """The entry point for the dense and vlm families; vlm's patches come
    after the tokens from one rng, and its cache holds the prefix too."""
    out = serve.serve_lm(serve.parser().parse_args(
        ["--arch", arch, "--preset", "tiny", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "3"]))
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["last_logits"]).all()
    assert "prefill: 2x16" in capsys.readouterr().out
