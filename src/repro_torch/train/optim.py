"""Hand-rolled optimizers, twins of ``repro.train.optim``: AdamW and Adafactor.

A tree here is a dict of tensors (a model's ``named_parameters``, or any
name -> tensor map), walked in its own order.  Each update follows the
reference's arithmetic term by term, in f32, so that the same gradients
give the same parameters: ``torch.optim.AdamW`` decays the weights before
the Adam step, a different rounding.  AdamW's moments may be kept in bf16
(``moment_dtype``, half the optimizer memory); Adafactor keeps factored
second moments (row/col).  The functions return new state and new
parameters and leave their arguments as they were; ``adamw_update_``
updates a model's live parameters and the state in place, leaf by leaf.

On a mesh each rank holds its slices of the parameters, gradients and
moments, and updates them alone; the clip needs the norm over every rank's
slices (``global_norm`` with ``counted`` and ``mesh``), which
``train.step`` hands to ``adamw_update_``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.dist import api as dist_api

Tree = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" halves optimizer memory


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Tree
    v: Tree


def _device(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device


def adamw_init(params: Tree, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda: {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                      m=zeros(), v=zeros())


def global_norm(tree: Tree, counted: dict | None = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over the leaves, in order, of each leaf's sum of
    squares in f32.  On a ``mesh``: each rank sums the leaves that
    ``counted`` names (its own slices, and one copy of each replicated
    leaf: ``dist.sharding.counted``), and the partial sums are summed over
    every rank."""
    total = None
    for k, leaf in tree.items():
        if counted is not None and not counted[k]:
            continue
        sq = torch.sum(leaf.float() ** 2)
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=_device(tree))
    if mesh is not None:
        total = dist_api.psum(total, dist_api.ALL, mesh)
    return torch.sqrt(total)


def _adamw_prologue(grads: Tree, state: AdamWState, cfg: AdamWConfig, norm=None):
    """(step + 1, the clip scale, the two bias corrections), all on the device;
    ``norm`` the gradients' global norm where the caller has it."""
    step = state.step + 1
    stepf = step.float()
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    return step, scale, 1 - (one * cfg.b1) ** stepf, 1 - (one * cfg.b2) ** stepf


def _adamw_leaf(g, m, v, p, scale, bc1, bc2, cfg: AdamWConfig):
    g = g.float() * scale
    m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
    v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
    mhat = m32 / bc1
    vhat = v32 / bc2
    p32 = p.float()
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
    dt = _DTYPES[cfg.moment_dtype]
    return (p32 - cfg.lr * delta).to(p.dtype), m32.to(dt), v32.to(dt)


@torch.no_grad()
def adamw_update_(grads: Tree, state: AdamWState, params: Tree,
                  cfg: AdamWConfig = AdamWConfig(), norm=None) -> AdamWState:
    """One AdamW step, in place: the gradients clipped by their global norm,
    then per leaf ``delta = mhat / (sqrt(vhat) + eps) + wd p`` and ``p - lr
    delta``, all in f32.  Each parameter is overwritten and each moment
    replaced in ``state``'s dicts as soon as it is computed, so the step
    needs one leaf's temporaries, not a second copy of the parameters and
    moments.  ``norm``: the gradients' global norm, where the caller has it
    (on a mesh: over every rank's slices).  Returns the state with the new
    step count."""
    step, scale, bc1, bc2 = _adamw_prologue(grads, state, cfg, norm)
    for k, p in params.items():
        p_new, state.m[k], state.v[k] = _adamw_leaf(grads[k], state.m[k], state.v[k], p,
                                                    scale, bc1, bc2, cfg)
        p.copy_(p_new)
    return AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def apply_(params: Tree, new: Tree) -> None:
    """Write ``new`` into the live parameters (a model's, in place)."""
    for k, p in params.items():
        p.copy_(new[k])


# ---------------------------------------------------------------------- #
# Adafactor (factored second moment) — memory-saver option               #
# ---------------------------------------------------------------------- #
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Tree     # row second moments (or full v for <2D params)
    vc: Tree


def adafactor_init(params: Tree) -> AdafactorState:
    def rows(p):
        shape = p.shape[:-1] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                          vr={k: rows(p) for k, p in params.items()},
                          vc={k: cols(p) for k, p in params.items()})


@torch.no_grad()
def adafactor_update(grads: Tree, state: AdafactorState, params: Tree, lr: float = 1e-3,
                     decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0
                     ) -> tuple[Tree, AdafactorState]:
    step = state.step + 1
    beta = 1.0 - step.float() ** -decay
    new_p, new_r, new_c = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        vr, vc = state.vr[k], state.vc[k]
        g2 = g * g + eps
        if g.dim() >= 2:
            vr_new = beta * vr + (1 - beta) * g2.mean(-1)
            vc_new = beta * vc + (1 - beta) * g2.mean(-2)
            r = vr_new / torch.clamp(vr_new.mean(-1, keepdim=True), min=eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc_new)[..., None, :] + eps)
        else:
            vr_new = beta * vr + (1 - beta) * g2
            vc_new = vc
            u = g / (torch.sqrt(vr_new) + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_r[k], new_c[k] = vr_new, vc_new
    return new_p, AdafactorState(step=step, vr=new_r, vc=new_c)
