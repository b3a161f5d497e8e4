"""One rank's step of every (arch x shape) cell (counterpart of
``repro.launch.specs``).

The reference builds ShapeDtypeStruct stand-ins and shardings and lets
``jax.jit`` place them; here a cell is the step as one rank runs it:
``Model(cfg, device=mesh.device)`` sliced by ``sharding.shard_model``, the
AdamW state of its slices for training, the rank's part of the decode
cache (``Model.cache_init`` under the mesh).  On a meta mesh
(``launch/mesh.py``) every tensor is a shape and a type, and ``fn(*args)``
runs the step without memory or arithmetic for the dry run; on a real
mesh it runs for real.

``args`` are the step's inputs as a user hands them over, the global batch
(``fn`` takes the rank's rows: ``prefill`` does itself, the train step,
the encoder's forward and the decode tokens through
``sharding.shard_batch``), except the decode cache, which is the rank's
part.  The byte counts come from the plans alone (``param_shardings``,
``opt_shardings``' mirror of the parameters, ``batch_shardings``,
``cache_shardings``) for every rank: ``rank_bytes``.  The ranks' bytes
differ where the plan's runs do: the expert stacks lie in runs of the
e_pad padded experts, of which a rank stores its real ones
(``sharding.expert_range``; granite's 40 experts pad to 48, 3 a rank on 16
model ranks, so ranks 13-15 hold 1, 0 and 0).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist import api as dist_api, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.train import optim
from repro_torch.train.step import make_train_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Cell:
    """One rank's step: ``fn(*args)``.  ``in_shardings``: per argument
    group ("params", "opt", "batch", "cache", "tokens") its plan;
    ``model``: the rank's model (its parameters are the step's too)."""
    fn: Callable
    args: tuple
    in_shardings: dict
    kind: str           # train | prefill | decode
    model: Model


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Name -> (shape, dtype) of a global batch of the cell's shape (the
    reference's ``batch_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.frontend == "audio_stub":
        return {"frames": ((b, s, cfg.frontend_dim), torch.bfloat16),
                "labels": ((b, s), i32),
                "mask_indices": ((b, s), torch.bool)}
    if cfg.frontend == "vision_stub":
        s_txt = s - cfg.n_prefix_tokens
        return {"patches": ((b, cfg.n_prefix_tokens, cfg.frontend_dim), torch.bfloat16),
                "tokens": ((b, s_txt), i32),
                "labels": ((b, s_txt), i32)}
    return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _coords(sizes: dict):
    """(data index, model index) of every rank, row-major over the axes."""
    names = list(sizes)
    for idx in itertools.product(*(range(sizes[a]) for a in names)):
        at = dict(zip(names, idx))
        didx = 0
        for a in ("pod", "data"):
            if a in sizes:
                didx = didx * sizes[a] + at[a]
        yield didx, at.get("model", 0)


def rank_bytes(model: Model, shape: ShapeSpec, sizes: dict, fsdp: bool) -> tuple[list, dict]:
    """Per rank (row-major), the bytes of each argument group it holds, and
    the plans: from the sizes of the mesh alone (no process group)."""
    cfg = model.cfg
    plan = sharding.placements(model, sizes, fsdp)
    params = {n: (p.shape, p.dtype) for n, p in model.named_parameters()}
    plans = {"params": sharding.param_shardings(sharding.stacked_shapes(model), sizes, fsdp)}
    groups: dict = {}                       # name -> {leaf: (shape, dtype)} split evenly
    if shape.kind == "train":
        moment = _DTYPES[optim.AdamWConfig().moment_dtype]
        batch = batch_specs(cfg, shape)
        plans["batch"] = sharding.batch_shardings({k: s for k, (s, _) in batch.items()}, sizes)
        groups["batch"] = batch
    elif shape.kind == "prefill":
        batch = {k: v for k, v in batch_specs(cfg, shape).items()
                 if k not in ("labels", "mask_indices")}
        plans["batch"] = sharding.batch_shardings({k: s for k, (s, _) in batch.items()}, sizes)
        groups["batch"] = batch
    else:
        b = shape.global_batch
        cache = model.cache_shapes(b, shape.seq_len)
        plans["cache"] = sharding.cache_shardings({k: s for k, (s, _) in cache.items()}, sizes,
                                                  batch=b)
        plans["tokens"] = sharding.batch_shardings({"tokens": (b, 1)}, sizes)
        groups["cache"] = cache
        groups["tokens"] = {"tokens": ((b, 1), torch.int32)}
    out = []
    for didx, midx in _coords(sizes):
        held = {n: sharding.placed_shape(plan[n], sizes, didx, midx) for n in params}
        row = {"params": sum(_nbytes(held[n], dt) for n, (_, dt) in params.items())}
        if shape.kind == "train":
            row["opt"] = 4 + 2 * sum(_nbytes(held[n], moment) for n in params)
        for g, leaves in groups.items():
            row[g] = sum(_nbytes(sharding.local_shape(s, plans[g][k], sizes), dt)
                         for k, (s, dt) in leaves.items())
        out.append(row)
    return out, plans


def largest_rank(per_rank: list) -> int:
    """The first rank that holds the most argument bytes."""
    totals = [sum(r.values()) for r in per_rank]
    return totals.index(max(totals))


def _meta_batch(specs: dict, device) -> dict:
    return {k: torch.empty(s, dtype=dt, device=device) for k, (s, dt) in specs.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, fsdp: bool = True,
               step_kwargs: dict | None = None) -> Cell:
    """The cell's step on this rank of ``mesh`` (its device: meta for the
    dry run).  Train: ``make_train_step(**step_kwargs)`` on AdamW's state
    of the rank's slices; prefill: ``Model.prefill`` (the encoder family:
    ``forward_logits``, its forward being its prefill); decode: one
    ``decode_step`` against the rank's part of a cache of ``seq_len``."""
    dev = mesh.device
    model = Model(cfg, device=dev)
    sizes = dict(mesh.shape)
    _, plans = rank_bytes(model, shape, sizes, fsdp)
    sharding.shard_model(model, mesh, fsdp=fsdp)

    def rows(b):
        return sharding.shard_batch(b, mesh)

    if shape.kind == "train":
        step = make_train_step(model, **(step_kwargs or {}))
        opt = optim.adamw_init(dict(model.named_parameters()))
        batch = _meta_batch(batch_specs(cfg, shape), dev)

        def fn(opt_state, b):
            with dist_api.use_mesh(mesh):
                return step(opt_state, rows(b))
        return Cell(fn, (opt, batch), plans, "train", model)

    if shape.kind == "prefill":
        batch = _meta_batch({k: v for k, v in batch_specs(cfg, shape).items()
                             if k not in ("labels", "mask_indices")}, dev)

        def fn(b):
            with dist_api.use_mesh(mesh):
                if cfg.family == "encoder":
                    return model.forward_logits(rows(b))
                return model.prefill(b, shape.seq_len)
        return Cell(fn, (batch,), plans, "prefill", model)

    b = shape.global_batch
    with dist_api.use_mesh(mesh):
        cache = model.cache_init(b, shape.seq_len)
    cache["pos"] = shape.seq_len - 1
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)

    def fn(c, toks):
        with dist_api.use_mesh(mesh):
            return model.decode_step(c, rows({"tokens": toks})["tokens"])
    return Cell(fn, (cache, tokens), plans, "decode", model)
