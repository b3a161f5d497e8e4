"""Transformer building blocks of the port: norms, RoPE, attention, MLP.

Twins of ``repro.models.layers`` as plain functions over explicit parameter
tuples.  Attention routes to ``kernels/attention/ops.py``: K5 on CUDA
tensors, its plain version on CPU tensors, with ``chunked_attention``'s
semantics (the layer window and ``prefix_len`` included).  ``moe_block`` is
the reference's single-device dispatch (no mesh); the sharded attention and
the expert-parallel MoE wait for ROADMAP queue 1 item 13.

bf16 arithmetic follows the reference op by op: ``silu`` is ``x *
sigmoid(x)``, two roundings, as ``jax.nn.silu`` is written.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import NEG_INF


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 * scale) * (1.0 + gain.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, n_heads, head_dim), positions (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnParams(NamedTuple):
    wq: torch.Tensor   # (d, H*hd)
    wk: torch.Tensor   # (d, KV*hd)
    wv: torch.Tensor   # (d, KV*hd)
    wo: torch.Tensor   # (H*hd, d)


def qkv(x: torch.Tensor, p: AttnParams, positions: torch.Tensor, cfg):
    """Projections with RoPE on q and k: (B, S, heads, hd) each."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope((x @ p.wq).reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope((x @ p.wk).reshape(b, s, kv, hd), positions, cfg.rope_theta)
    v = (x @ p.wv).reshape(b, s, kv, hd)
    return q, k, v


def attention_block(x: torch.Tensor, p: AttnParams, positions: torch.Tensor, cfg,
                    layer_window: int = 0, prefix_len: int = 0,
                    kv: tuple | None = None) -> torch.Tensor:
    """proj -> rope -> attention (K5 on the card) -> out proj.

    ``kv`` takes projections already made by ``qkv`` (prefill reuses them
    for its cache)."""
    b, s, _ = x.shape
    q, k, v = kv if kv is not None else qkv(x, p, positions, cfg)
    out = attn_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=layer_window, softcap=cfg.attn_softcap,
        prefix_len=prefix_len)
    return out.transpose(1, 2).reshape(b, s, -1) @ p.wo


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len: torch.Tensor, *, softcap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) against a cache (B, Smax, KV, D).

    Positions >= cur_len are masked.  Plain torch, in f32 (the reference
    has no kernel here)."""
    b, _, h, d = q.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, kvh, h // kvh, d).float()
    logits = torch.einsum("bkrd,bskd->bkrs", qr, k_cache.float()) / (d ** 0.5)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(smax, device=q.device)
    valid = pos[None, :] < cur_len[:, None]
    if window > 0:
        valid &= (cur_len[:, None] - 1 - pos[None, :]) < window
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (d, ff)
    w_up: torch.Tensor     # (d, ff)
    w_down: torch.Tensor   # (ff, d)


def mlp_block(x: torch.Tensor, p: MLPParams) -> torch.Tensor:
    return (silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class MoEParams(NamedTuple):
    router: torch.Tensor   # (d, E)
    w_gate: torch.Tensor   # (E, d, ffe)
    w_up: torch.Tensor     # (E, d, ffe)
    w_down: torch.Tensor   # (E, ffe, d)


def expert_counts(idx: torch.Tensor, e: int, dtype: torch.dtype) -> torch.Tensor:
    """How many entries of ``idx`` name each of ``e`` experts (bincount's
    counts), as a scatter of ones: bincount reads its input's range back to
    the host on CUDA."""
    ones = torch.ones(idx.shape, dtype=dtype, device=idx.device)
    return torch.zeros(e, dtype=dtype, device=idx.device).scatter_add_(0, idx, ones)


def combine_top_k(gathered: torch.Tensor, order: torch.Tensor,
                  gate_idx: torch.Tensor) -> torch.Tensor:
    """Each token's k expert rows summed, with no atomics.

    ``gathered`` (T k, d) holds the rows in the order of the stable sort by
    expert (``order`` its permutation of the flat (T, k) choices),
    ``gate_idx`` (T, k) the experts.  The reference's scatter
    (``.at[st].add``) adds a token's rows in update order, the sorted one,
    i.e. by ascending expert id.  So: undo the sort, lay the rows out
    (T, k, d), order each token's k rows by expert id and add them one at a
    time in the rows' type, from zero."""
    t, k = gate_idx.shape
    d = gathered.shape[-1]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    rows = gathered[inv].reshape(t, k, d)
    by_expert = torch.argsort(gate_idx, dim=-1)          # a token's experts are distinct
    rows = torch.gather(rows, 1, by_expert[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=gathered.dtype, device=gathered.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def _moe_dispatch_chunk(xf: torch.Tensor, p: MoEParams, top_k: int,
                        cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, compute and combine for one token chunk xf (T, d).

    The reference's slot layout: choices sorted stably by expert, the first
    ``cap`` of each expert kept at ``expert * cap + rank``, the rest sent to
    a trash slot that is never read back.  The reference pads E to a
    multiple of ``expert_pad`` (16) and computes the padded experts on zero
    rows; here only the E real experts are computed and the trash slot
    follows them, which gives the same output.  The expert products take
    the compute-type operands widened to f32 (exact) into an f32 product, as
    ``preferred_element_type=f32`` has them; on the card that needs TF32 off
    (PyTorch's default).  Nothing here reads a value back to the host, and
    the combine uses no atomics: on the card two runs give the same bits."""
    t, d = xf.shape
    e = p.router.shape[-1]
    dev = xf.device
    probs = torch.softmax((xf @ p.router).float(), dim=-1)            # (T, E)
    # lax.top_k takes the lower expert first among equal gates, and a stable
    # descending sort does too (torch.topk leaves that order unspecified).
    # Under bf16 the router logits are rounded to 8 bits, so equal gates
    # are common.
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :top_k], gate_idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balancing auxiliary loss.
    flat_e = gate_idx.reshape(-1)
    ce = expert_counts(flat_e, e, torch.float32) / (t * top_k)
    aux = e * torch.sum(probs.mean(0) * ce)

    # stable, or the choices past an expert's capacity differ from the reference's
    se, order = torch.sort(flat_e, stable=True)
    sw = gate_vals.reshape(-1)[order]
    counts = expert_counts(se, e, torch.long)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))

    # token t's k copies (an expand, whose gradient is a sum, not atomics)
    # in sorted order
    xs = xf[:, None].expand(t, top_k, d).reshape(t * top_k, d)[order]
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xs, torch.zeros((), dtype=xf.dtype, device=dev))
    buf = buf[:-1].reshape(e, cap, d).float()
    hgate = torch.bmm(buf, p.w_gate.float())
    hup = torch.bmm(buf, p.w_up.float())
    hout = torch.bmm(silu(hgate) * hup, p.w_down.float()).to(xf.dtype)

    yflat = torch.cat([hout.reshape(e * cap, d),
                       torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    gathered = yflat[slot] * (sw * keep)[:, None].to(xf.dtype)
    out = combine_top_k(gathered, order, gate_idx)
    return out, aux


def moe_block(x: torch.Tensor, p: MoEParams, top_k: int,
              capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity over x (B, S, d): (out (B, S, d), aux loss).

    The reference's single-device branch: every token of the batch in one
    chunk, ``cap = min(int(max(4, T k / E * capacity_factor)), T)``."""
    b, s, d = x.shape
    e = p.router.shape[-1]
    t = b * s
    cap = min(int(max(4, (t * top_k / e) * capacity_factor)), t)
    out, aux = _moe_dispatch_chunk(x.reshape(t, d), p, top_k, cap)
    return out.reshape(b, s, d), aux
