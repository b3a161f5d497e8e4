#!/usr/bin/env python3
"""How far bf16 rounding moves the LM's gradients, against how far the
mesh's tensor parallelism moves them (on the CPU).

granite-moe-3b-a800m's layout (24/8 heads, 40 experts, top 8) at a reduced
width (``--d-model``, ``--layers``), bf16 compute: the gradient of one loss
on a ("data", "model") mesh (1, 2) of two gloo ranks, gathered, against the
same model's one-process gradient in bf16 and in f32 compute.  Prints, per
leaf, max |difference| over the f32 gradient's largest |g|:
``mesh-bf16`` (the mesh's extra roundings), ``bf16-f32`` (bf16's own) and
``mesh-f32``.  From the repository root:

    PYTHONPATH=src python scripts/mesh_bf16_grad_floor.py
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.tokens import batch_for_config
from repro_torch.dist import api as dist_api, sharding
from repro_torch.models.transformer import Model

LEAVES = ("layers.0.wq", "layers.0.wo", "layers.0.moe.router", "layers.0.moe.w_gate",
          "embed", "head")


def _cfg(args, compute_dtype):
    return get_config("granite-moe-3b-a800m").reduced(
        compute_dtype=compute_dtype, n_layers=args.layers, d_model=args.d_model, n_heads=24,
        n_kv_heads=8, head_dim=32, d_ff=args.d_model,
        n_experts=40, top_k=8, remat="block")


def _batch(cfg, args):
    return {k: torch.as_tensor(v) for k, v in
            batch_for_config(cfg, 2, args.seq, 0).items()}


def _rank(mesh, args):
    cfg = _cfg(args, "bfloat16")
    model = sharding.shard_model(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), mesh).trainable()
    params = dict(model.named_parameters())
    with dist_api.use_mesh(mesh):
        loss, _ = model.loss_fn(sharding.shard_batch(_batch(cfg, args), mesh))
        for p, g in zip(params.values(), torch.autograd.grad(loss, list(params.values()))):
            p.grad = g
        return {k: sharding.gather_param(model, k, mesh, grads=True) for k in LEAVES}


def _one(args, compute_dtype):
    cfg = _cfg(args, compute_dtype)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).trainable()
    params = dict(model.named_parameters())
    loss, _ = model.loss_fn(_batch(cfg, args))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return {k: grads[k] for k in LEAVES}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()
    mesh = dist_api.spawn(_rank, 2, args, mesh_shape=(1, 2), mesh_names=("data", "model"))[0]
    b16, f32 = _one(args, "bfloat16"), _one(args, "float32")
    for k in LEAVES:
        scale = f32[k].float().abs().max().item()

        def gap(a, b):
            return (a.float() - b.float()).abs().max().item() / scale
        print(json.dumps({"leaf": k, "mesh-bf16": gap(mesh[k], b16[k]),
                          "bf16-f32": gap(b16[k], f32[k]), "mesh-f32": gap(mesh[k], f32[k])}))


if __name__ == "__main__":
    main()
