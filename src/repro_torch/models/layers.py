"""Transformer building blocks of the port: norms, RoPE, attention, MLP.

Twins of ``repro.models.layers`` as plain functions over explicit parameter
tuples.  Attention routes to ``kernels/attention/ops.py``: K5 on CUDA
tensors, its plain version on CPU tensors, with ``chunked_attention``'s
semantics (the layer window and ``prefix_len`` included).  MoE and the
sharded attention wait for their slices (ROADMAP queue 1 items 13, 14).

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
