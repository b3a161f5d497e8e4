"""The port's LM loss and its gradients (``Model.loss_fn``) against the JAX package.

The port's ``Model.init`` parameters reach the JAX package through
``repro_torch.convert.lm_params_to_numpy``, and the batch comes from ``data.tokens.batch_for_config`` (numpy, the same
arrays in both packages).  ``loss_fn`` and every gradient leaf are held
against ``jax.value_and_grad(Model.loss_fn)`` for the hybrid (zamba2), moe
(granite, top 2 of 4 experts), dense (gemma2) and vlm (paligemma) families
at ``reduced()`` sizes, f32, ``remat "block"`` (the port's per-layer
activation checkpoints, chunked CE): the loss, ce and aux within 1e-5
relative, each leaf within 1e-4 of that leaf's largest |g| (f32 sums in
other orders: ~3e-6 seen).  bf16 (zamba2): the loss within 1e-2 relative
and each leaf within 1e-1 of its largest |g| (bf16 rounds at other places
in the two frameworks; 3.2e-2 seen; the forward's bar is 5e-2 of the
largest logit).  The train step, the optimizers and the rest of ``train/``
are held in ``tests/test_torch_train_step.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.transformer import Model as JModel
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data import tokens
from repro_torch.models.transformer import Model
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH, SEQ = 2, 32


def _flat(tree) -> dict:
    """A JAX (or numpy) tree as {path: numpy array} in JAX's order."""
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves_close(got, want, rel):
    """Every leaf within ``rel`` of that leaf's largest |value|."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (k, err, np.abs(w).max())


def _pair(arch, compute_dtype="float32", **over):
    """(JAX model, its params, the port's model on the same params).  The
    port draws them (``Model.init``, seeded; a JAX init costs seconds of
    eager compiles) and ``convert.lm_params_to_numpy`` hands them over."""
    over = dict(compute_dtype=compute_dtype, **over)
    tm = Model(get_config(arch).reduced(**over), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(tm))
    return JModel(jget_config(arch).reduced(**over)), params, tm



# --------------------------------------------------------------------- #
# loss and gradients                                                    #
# --------------------------------------------------------------------- #
LOSS_CASES = [
    # (arch, compute dtype, overrides, loss rtol, leaf bar)
    ("zamba2-1.2b", "float32", {}, 1e-5, 1e-4),
    ("granite-moe-3b-a800m", "float32", {"top_k": 2}, 1e-5, 1e-4),
    ("gemma2-9b", "float32", {}, 1e-5, 1e-4),
    ("paligemma-3b", "float32", {}, 1e-5, 1e-4),
    ("zamba2-1.2b", "bfloat16", {}, 1e-2, 1e-1),
]


@pytest.mark.parametrize("arch,compute_dtype,over,loss_rtol,leaf_rel", LOSS_CASES)
def test_loss_and_every_gradient_leaf_match_jax(arch, compute_dtype, over, loss_rtol, leaf_rel):
    jm, params, tm = _pair(arch, compute_dtype, **over)
    cfg = tm.cfg
    b = tokens.batch_for_config(cfg, BATCH, SEQ + cfg.n_prefix_tokens, 0)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, jax.tree.map(jnp.asarray, b))
    tm.trainable()
    loss, aux = tm.loss_fn(tokens.to_device(b, "cpu"))
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=loss_rtol)
    for k in ("ce", "aux"):
        assert aux[k].item() == pytest.approx(float(jaux[k]), rel=loss_rtol, abs=1e-7)
    if cfg.family == "moe":
        assert aux["aux"].item() > 0
    _leaves_close(convert.lm_params_to_numpy(tm, grads=True), jg, leaf_rel)
