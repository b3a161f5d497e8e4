"""The train and serve steps of the port (twin of ``repro.train.step``).

``make_train_step`` returns a step that updates the model's parameters in
place: the reference's step is a pure function of (params, opt_state,
batch), here the parameters live in the ``Model``.  The gradients of the
step stay on the parameters' ``.grad`` (in their type) until the next step.

On a mesh (the model sliced by ``dist.sharding.shard_model``, the step
called inside ``dist.api.use_mesh`` with the rank's rows of the batch)
each rank's backward gives its share of the global loss's gradient: the
step sums them over "data" (where FSDP's gather has not already
reduce-scattered them), takes the global norm over every rank's slices,
and AdamW updates the rank's slices.
"""
from __future__ import annotations

import torch

from repro_torch.dist import api as dist_api, sharding
from repro_torch.models.transformer import Model
from repro_torch.train import optim

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig | None = None,
                    num_microbatches: int = 1, grad_dtype: str | None = None):
    """Returns train_step(opt_state, batch) -> (opt_state, metrics), with
    metrics {"ce", "aux", "loss", "grad_norm"} as 0-dim tensors (nothing is
    read back to the host).  Makes the model ``trainable``.

    ``num_microbatches > 1``: gradient accumulation.  The batch is split
    along dim 0, the micro-batch gradients are summed in f32 and scaled by
    1/n, and, as in the reference, ce is then the mean loss and aux 0.

    ``grad_dtype="bfloat16"``: the gradients are taken with respect to bf16
    copies of the parameters (the model computes from them), and AdamW then
    updates the f32 masters.  The copies stand in the parameters' ``.data``
    for the forward and backward (so that an activation checkpoint's
    recompute reads them too) and the masters come back after.
    """
    opt_cfg = opt_cfg or optim.AdamWConfig()
    model.trainable()
    params = dict(model.named_parameters())
    low = None if grad_dtype is None else _DTYPES[grad_dtype]

    def grads_of(batch):
        masters = {k: p.data for k, p in params.items()}
        try:
            if low is not None:
                for p in params.values():
                    p.data = p.data.to(low)
            loss, metrics = model.loss_fn(batch)
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), got)}
        finally:
            for k, p in params.items():
                p.data = masters[k]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(opt_state: optim.AdamWState, batch: dict):
        for p in params.values():
            p.grad = None
        if num_microbatches == 1:
            loss, metrics, grads = grads_of(batch)
        else:
            n = num_microbatches
            micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(n):
                loss_i, _, g = grads_of({k: v[i] for k, v in micro.items()})
                grads = {k: grads[k] + g[k] for k in grads}
                loss = loss + loss_i
            grads = {k: g * (1.0 / n) for k, g in grads.items()}
            loss = loss * (1.0 / n)
            metrics = {"ce": loss, "aux": torch.zeros((), device=model.device)}
        if model.placement is not None:
            mesh = dist_api.current()
            grads = sharding.sync_grads(grads, model, mesh)
            grad_norm = optim.global_norm(
                grads, {k: sharding.counted(model.placement[k], mesh) for k in grads}, mesh)
        else:
            grad_norm = optim.global_norm(grads)
        opt_state = optim.adamw_update_(grads, opt_state, params, opt_cfg, grad_norm)
        model.weights_changed()
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
        return opt_state, dict(metrics, loss=loss, grad_norm=grad_norm)

    return train_step


def make_serve_steps(model: Model, max_len: int):
    """Returns (prefill_step(batch), decode_step(cache, tokens)) for serving."""

    def prefill_step(batch):
        return model.prefill(batch, max_len)

    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return prefill_step, decode_step
