"""The port's training substrate (``repro_torch.train``, ``data.tokens``) against the JAX package.

The same numpy inputs (and the port's ``Model.init`` parameters,
through ``repro_torch.convert``) go to both packages:

- AdamW (f32 and bf16 moments) and Adafactor over three steps on the same
  gradients: parameters and state within 1e-6 (f32 arithmetic in the same
  order; XLA may fuse a multiply-add, one rounding of an O(1) value);
- ``batch_for_config``: bit-identical arrays for every modality;
- ``grad_compress``'s local half: exact (int8 codes and scales; rounding
  half to even in both);
- the train step with ``num_microbatches=2`` and with ``grad_dtype
  ="bfloat16"`` against the reference's: loss and grad norm within 1e-5
  relative; the updated parameters within 1e-2 of the learning rate but
  for at most 1e-3 of each leaf's entries, and all within 2 lr.  The first
  AdamW step moves a parameter by lr·g/(|g| + eps), whose slope 1/eps near
  g = 0 turns a gradient difference of 1e-10 into 1e-2 of lr, and a
  gradient of noise size may change sign: up to 2 lr.  (Seen: f32 at most
  1e-2 lr; bf16 gradients 2 of 65,536 entries beyond, the worst 4.6e-2 lr.)

The reference's SSD gradient is NaN wherever exp(seg) overflows above the
chunk's diagonal (``repro/kernels/ssd/ref.py``, ``where(mask, exp(seg),
0)``): the inputs of the gradient tests keep it finite, and one test here
shows the port's gradient finite where the reference's is not (ROADMAP
queue 3).  ``Model.loss_fn``'s gradients are held in
``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data import tokens as jtokens
from repro.kernels.ssd import ref as jssd_ref
from repro.train import grad_compress as jgc, optim as joptim, step as jstep
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data import tokens
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref
from repro_torch.models.transformer import Model
from repro_torch.train import grad_compress, optim, step
from test_torch_train import BATCH, SEQ, _flat, _pair
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)


def _port(arch, **over):
    """The port's model of the reduced config alone, from a seeded init."""
    cfg = get_config(arch).reduced(compute_dtype="float32", **over)
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


# --------------------------------------------------------------------- #
# optimizers                                                            #
# --------------------------------------------------------------------- #
def _opt_problem(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 2).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def _tt(tree):
    """Tensors of their own (the JAX arrays may share the numpy memory, and
    the port's update writes in place)."""
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moment_dtype):
    params, grads = _opt_problem()
    cfg = joptim.AdamWConfig(moment_dtype=moment_dtype)
    tcfg = optim.AdamWConfig(moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.adamw_init(jp, cfg)
    tp = _tt(params)
    ts = optim.adamw_init(tp, tcfg)
    update = jax.jit(joptim.adamw_update, static_argnums=3)
    for g in grads:
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp, cfg)
        ts = optim.adamw_update_(_tt(g), ts, tp, tcfg)
        assert float(optim.global_norm(_tt(g))) == pytest.approx(
            float(joptim.global_norm(g)), rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for k in want:
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                       rtol=0, atol=1e-6)
    assert ts.m["a"].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]


def test_adafactor_matches_jax():
    params, grads = _opt_problem(1)
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.adafactor_init(jp)
    tp = _tt(params)
    ts = optim.adafactor_init(tp)
    update = jax.jit(joptim.adafactor_update)
    for g in grads:
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = optim.adafactor_update(_tt(g), ts, tp)
    for got, want in ((tp, jp), (ts.vr, js.vr), (ts.vc, js.vc)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6)


# --------------------------------------------------------------------- #
# data, gradient compression                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["gemma2-9b", "hubert-xlarge", "paligemma-3b"])
def test_batch_for_config_is_bit_identical(arch):
    cfg = get_config(arch).reduced()
    for step_no in (0, 3):
        got = tokens.batch_for_config(cfg, 3, 24, step_no, seed=2)
        want = jtokens.batch_for_config(jget_config(arch).reduced(), 3, 24, step_no, seed=2)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    ts = tokens.TokenStream(cfg.vocab, 4, 16, seed=1)
    jts = jtokens.TokenStream(cfg.vocab, 4, 16, seed=1)
    for k, v in jts.batch_at(5, slice(1, 3)).items():
        assert np.array_equal(ts.batch_at(5, slice(1, 3))[k], v)
    dev = tokens.to_device(got, "cpu")
    assert all(t.dtype in (torch.int64, torch.float32, torch.bool) for t in dev.values())


def test_grad_compress_local_half_is_exact():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=5000) * 3).astype(np.float32)
    x[:2048] = np.arange(2048) % 255 - 127 + 0.5        # block 0: scale 1, ties at .5
    x[0] = 127.0
    q, s = grad_compress._quantize(torch.as_tensor(x))
    jq, js = jgc._quantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(grad_compress.compress_roundtrip(torch.as_tensor(x)).numpy(),
                          np.asarray(jgc.compress_roundtrip(jnp.asarray(x))))
    g = {"w": rng.normal(size=(30, 70)).astype(np.float32), "b": rng.normal(size=9).astype(np.float32)}
    e = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in g.items()}
    tc, te = grad_compress.ErrorFeedback.apply(_tt(g), _tt(e), block=64)
    jc, je = jgc.ErrorFeedback.apply(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e),
                                     block=64)
    for k in g:
        assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        assert np.array_equal(te[k].numpy(), np.asarray(je[k]))
    assert all(torch.count_nonzero(v) == 0
               for v in grad_compress.ErrorFeedback.init(_tt(g)).values())


@pytest.mark.parametrize("arch,over,nmb,grad_dtype", [
    ("zamba2-1.2b", {}, 2, None),
    ("gemma2-9b", {}, 1, "bfloat16"),
], ids=["zamba2-microbatches", "gemma2-bf16-grads"])
def test_train_step_matches_jax(arch, over, nmb, grad_dtype):
    jm, params, tm = _pair(arch, "float32", **over)
    b = tokens.batch_for_config(tm.cfg, 4, SEQ, 0)
    jstep_fn = jax.jit(jstep.make_train_step(jm, None, nmb, grad_dtype))
    jp, _, jmet = jstep_fn(params, joptim.adamw_init(params), jax.tree.map(jnp.asarray, b))
    step_fn = step.make_train_step(tm, None, nmb, grad_dtype)
    opt, met = step_fn(optim.adamw_init(dict(tm.named_parameters())), tokens.to_device(b, "cpu"))
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-7), k
    assert int(opt.step) == 1
    got, want = _flat(convert.lm_params_to_numpy(tm)), _flat(jp)
    lr = optim.AdamWConfig().lr
    for k in want:
        err = np.abs(got[k] - want[k])
        assert err.max() <= 2 * lr and np.mean(err > 1e-2 * lr) <= 1e-3, (k, err.max() / lr)


def test_step_drops_the_serving_weights():
    """forward_logits (no grad, cached compute-type weights) after a step
    sees the updated parameters, not the cast copies of before."""
    tm = _port("gemma2-9b")
    b = tokens.to_device(tokens.batch_for_config(tm.cfg, BATCH, SEQ, 0), "cpu")
    before = tm.forward_logits(b)
    step.make_train_step(tm)(optim.adamw_init(dict(tm.named_parameters())), b)
    after = tm.forward_logits(b)
    fresh = convert.lm_params_from_numpy(tm.cfg, convert.lm_params_to_numpy(tm), device="cpu")
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh.forward_logits(b))


def test_params_round_trip_through_numpy():
    tm = _port("zamba2-1.2b")
    back = convert.lm_params_from_numpy(tm.cfg, convert.lm_params_to_numpy(tm), device="cpu")
    for (k, a), (_, b) in zip(tm.named_parameters(), back.named_parameters(), strict=True):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("remat", ["block", "none"])
def test_kernel_calls_of_a_step(monkeypatch, remat):
    """What the card's launch counts must read on a training step: K6 once
    a layer and K5 once a shared-block application in the forward, again in
    each layer's recompute under remat "block", and none in the backward
    (its plain versions), counted here through the wrappers' CPU branch."""
    calls = {"attn": 0, "ssd": 0, "attn_plain_grad": 0, "ssd_plain_grad": 0}
    for mod, name, key, ref_mod, ref_name in (
            (attn_ops, "_forward", "attn", attn_ops.ref, "attention_ref"),
            (ssd_ops, "_forward", "ssd", ssd_ops.ref, "ssd_chunked_ref")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
        orig_ref = getattr(ref_mod, ref_name)

        def counted_ref(*a, _orig=orig_ref, _key=key + "_plain_grad", **kw):
            if torch.is_grad_enabled():          # the backward's recompute
                calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ref_mod, ref_name, counted_ref)
    tm = _port("zamba2-1.2b", n_layers=4, remat=remat)
    b = tokens.to_device(tokens.batch_for_config(tm.cfg, BATCH, SEQ, 0), "cpu")
    step.make_train_step(tm)(optim.adamw_init(dict(tm.named_parameters())), b)
    per = 2 if remat == "block" else 1
    napp = tm.cfg.n_layers // tm.cfg.shared_attn_every
    assert calls == {"attn": per * napp, "ssd": per * tm.cfg.n_layers,
                     "attn_plain_grad": napp, "ssd_plain_grad": tm.cfg.n_layers}
    with torch.no_grad():
        calls.update(attn=0, ssd=0)
        tm.forward_logits(b)
    assert (calls["attn"], calls["ssd"]) == (napp, tm.cfg.n_layers)


def test_ssd_gradient_finite_where_the_reference_overflows():
    """A chunk of 64 steps of dt 2 at a = -1: exp(seg) above the diagonal
    reaches e^126, past f32.  The forward is the reference's bit for bit;
    the reference's gradient is NaN, the port's finite."""
    rng = np.random.default_rng(4)
    b, s, h, p, g, n, q = 1, 64, 2, 4, 1, 4, 64
    args = [rng.normal(size=(b, s, h, p)), np.full((b, s, h), 2.0), -np.ones(h),
            rng.normal(size=(b, s, g, n)), rng.normal(size=(b, s, g, n)), np.ones(h)]
    args = [np.asarray(a, np.float32) for a in args]
    jx, jdt, *jrest = map(jnp.asarray, args)
    jy, jgdt = jax.jit(jax.value_and_grad(
        lambda dt: jssd_ref.ssd_batched_ref(jx, dt, *jrest, chunk=q).sum()))(jdt)
    jy = jssd_ref.ssd_batched_ref(jx, jdt, *jrest, chunk=q)
    assert np.isnan(np.asarray(jgdt)).any()
    x, dt, *rest = map(torch.as_tensor, args)
    dt.requires_grad_()
    y = ssd_ops.ssd_forward(x, dt, *rest, chunk=q)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    y.sum().backward()
    assert torch.isfinite(dt.grad).all()
    y_ref, _ = ssd_ref.ssd_chunked_ref(*map(torch.as_tensor, args), q)
    assert torch.equal(y.detach(), y_ref)
