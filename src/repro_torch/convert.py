"""Build the port's objects from numpy arrays (e.g. the JAX package's state).

Each stage can then be held against the reference in isolation: a JAX
``HSSMatrix`` goes into the port's ``factorize``, a JAX factorization into
the port's ADMM, a JAX-trained model into the port's scoring.  The one
format difference is the root LU pivots: ``jax.scipy.linalg.lu_factor``
returns 0-based pivots, ``torch.linalg.lu_factor`` 1-based (LAPACK) ones.
An LM's parameter dict (``Model.init`` of the JAX package, as numpy) becomes
the port's ``Model`` through ``lm_params_from_numpy``, and the way back,
``lm_params_to_numpy``, gives a model's parameters (or their gradients) in
that layout.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine import EngineModel
from repro_torch.core.factorization import HSSFactorization
from repro_torch.core.hss import HSSMatrix
from repro_torch.core.kernelfn import KernelSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import AttnParams, MLPParams, MoEParams
from repro_torch.models.ssm import SSMParams
from repro_torch.models.transformer import AttnBlock, Model


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def hss_from_numpy(*, x: np.ndarray, d_leaf: np.ndarray, u_leaf: np.ndarray,
                   skel_leaf: np.ndarray, transfers: Sequence[np.ndarray],
                   skels: Sequence[np.ndarray], b_mats: Sequence[np.ndarray],
                   levels: int, leaf_size: int,
                   leaf_ranks: np.ndarray | None = None,
                   level_ranks: Sequence[np.ndarray] = (),
                   device="cuda") -> HSSMatrix:
    """An ``HSSMatrix`` from its arrays; ``leaf_ranks``/``level_ranks`` make
    it an adaptive-rank one."""
    return HSSMatrix(
        x=_t(x, device), d_leaf=_t(d_leaf, device), u_leaf=_t(u_leaf, device),
        skel_leaf=_t(skel_leaf, device),
        transfers=tuple(_t(a, device) for a in transfers),
        skels=tuple(_t(a, device) for a in skels),
        b_mats=tuple(_t(a, device) for a in b_mats),
        levels=int(levels), leaf_size=int(leaf_size),
        leaf_ranks=None if leaf_ranks is None else _t(leaf_ranks, device),
        level_ranks=tuple(_t(a, device) for a in level_ranks))


def factorization_from_numpy(*, e_leaf: np.ndarray, g_leaf: np.ndarray,
                             e_lvls: Sequence[np.ndarray],
                             g_lvls: Sequence[np.ndarray], root_lu: np.ndarray,
                             root_piv: np.ndarray, levels: int, leaf_size: int,
                             beta: float, device="cuda") -> HSSFactorization:
    """An ``HSSFactorization`` from its arrays; ``root_piv`` is 0-based as
    ``jax.scipy.linalg.lu_factor`` returns it (a levels = 0 factorization
    holds a Cholesky factor there and its pivots are unused)."""
    return HSSFactorization(
        e_leaf=_t(e_leaf, device), g_leaf=_t(g_leaf, device),
        e_lvls=tuple(_t(a, device) for a in e_lvls),
        g_lvls=tuple(_t(a, device) for a in g_lvls),
        root_lu=_t(root_lu, device),
        root_piv=_t(np.asarray(root_piv, np.int32) + 1, device),
        levels=int(levels), leaf_size=int(leaf_size), beta=float(beta))


def engine_model_from_numpy(*, x_perm: np.ndarray, z_y: np.ndarray,
                            biases: np.ndarray, classes: np.ndarray, h: float,
                            kernel_name: str = "gaussian",
                            beta: float | None = None, c_value: float = 1.0,
                            binary: bool | None = None, strategy: str = "ovr",
                            task: str = "svm", pairs: np.ndarray | None = None,
                            device="cuda") -> EngineModel:
    """An ``EngineModel`` of kernel ``kernel_name``, any task: ``z_y`` is
    (d, P) or (d,).  ``binary`` defaults to what the engine decides: an
    "svm" model whose classes are exactly {-1, 1}."""
    classes = np.asarray(classes)
    if binary is None:
        binary = (task == "svm" and classes.shape[0] == 2
                  and set(np.asarray(classes, np.float64).tolist()) == {-1.0, 1.0})
    z_y = np.asarray(z_y, np.float32).reshape(np.asarray(x_perm).shape[0], -1)
    return EngineModel(
        x_perm=_t(np.asarray(x_perm, np.float32), device), z_y=_t(z_y, device),
        biases=_t(np.asarray(biases, np.float32).reshape(-1), device),
        classes=classes, spec=KernelSpec(kernel_name, float(h)),
        c_value=float(c_value), binary=bool(binary), strategy=strategy, task=task,
        pairs=None if pairs is None else np.asarray(pairs),
        beta=None if beta is None else float(beta))


@torch.no_grad()
def lm_params_from_numpy(cfg: ModelConfig, params: dict, device="cuda") -> Model:
    """The port's ``Model`` of ``cfg`` holding ``params``: the nested dict
    that the JAX ``Model.init`` returns (per-layer leaves stacked over L),
    as numpy arrays, for every family.  Both then compute the same function."""
    model = Model(cfg, device=device)

    def put(p: torch.nn.Parameter, a):
        p.copy_(torch.as_tensor(np.array(a)).to(p.dtype))

    def put_block(block, tree, idx=None):
        """An ``AttnBlock``'s leaves: ``ln1``, ``ln2``, ``attn``, ``mlp``, ``moe``."""
        at = (lambda a: a) if idx is None else (lambda a: a[idx])
        put(block.ln1, at(tree["ln1"]))
        put(block.ln2, at(tree["ln2"]))
        for name in AttnParams._fields:
            put(getattr(block, name), at(tree["attn"][name]))
        if block.has_mlp:
            for name in MLPParams._fields:
                put(getattr(block, name), at(tree["mlp"][name]))
        if block.moe is not None:
            for name in MoEParams._fields:
                put(getattr(block.moe, name), at(tree["moe"][name]))

    put(model.embed, params["embed"])
    put(model.final_norm, params["final_norm"])
    for name in ("head", "vision_proj", "frontend_proj", "mask_emb"):
        if getattr(model, name) is not None:
            put(getattr(model, name), params[name])
    lp = params["layers"]
    for idx, layer in enumerate(model.layers):
        if isinstance(layer, AttnBlock):
            put_block(layer, lp, idx)
            continue
        put(layer.ln1, lp["ln1"][idx])
        for name in SSMParams._fields:
            put(getattr(layer, name), lp["ssm"][name][idx])
    if model.shared is not None:
        put_block(model.shared, params["shared"])
    return model


def lm_params_to_numpy(model: Model, grads: bool = False) -> dict:
    """The port's parameters (``grads``: their ``.grad``, zeros where there
    is none) as the nested dict of the JAX ``Model.init``: per-layer leaves
    stacked over L, numpy copies in the parameters' type (bf16 as f32)."""
    def get(p: torch.nn.Parameter) -> np.ndarray:
        t = p.grad if grads else p
        t = torch.zeros_like(p) if t is None else t.detach()
        # a copy: on the CPU .numpy() would share the parameter's memory,
        # which a training step then overwrites in place
        return (t.float() if t.dtype == torch.bfloat16 else t).to("cpu", copy=True).numpy()

    def block(b) -> dict:
        out = {"ln1": get(b.ln1), "ln2": get(b.ln2),
               "attn": {n: get(getattr(b, n)) for n in AttnParams._fields}}
        if b.has_mlp:
            out["mlp"] = {n: get(getattr(b, n)) for n in MLPParams._fields}
        if b.moe is not None:
            out["moe"] = {n: get(getattr(b.moe, n)) for n in MoEParams._fields}
        return out

    def stack(trees: list):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    out = {"embed": get(model.embed), "final_norm": get(model.final_norm)}
    for name in ("head", "vision_proj", "frontend_proj", "mask_emb"):
        if getattr(model, name) is not None:
            out[name] = get(getattr(model, name))
    out["layers"] = stack([
        block(lay) if isinstance(lay, AttnBlock) else
        {"ln1": get(lay.ln1), "ssm": {n: get(getattr(lay, n)) for n in SSMParams._fields}}
        for lay in model.layers])
    if model.shared is not None:
        out["shared"] = block(model.shared)
    return out
