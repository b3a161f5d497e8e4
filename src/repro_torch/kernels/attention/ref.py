"""Plain PyTorch attention: the function K5 computes (any device).

The semantics are those of the model path, ``repro.models.layers
.chunked_attention`` with its ``_block_mask``: causal masking, a sliding
window (``(q - k) < window``; 0 or None is global), prefix keys that every
query sees (``prefix_len``, the prefix-LM mask), tanh logit softcap, and GQA
by head group.  Numerics: the scale is the Python float ``1/sqrt(D)``
(rounded to f32 where it meets the f32 logits), logits, softmax and P·V in
f32, masked logits at -1e30, the output cast once to the input type.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
            window: int | None, prefix_len: int) -> torch.Tensor:
    """(Sq, Sk) bool mask of ``_block_mask``: window <= 0 or None is global,
    prefix positions are always visible."""
    q = qpos[:, None]
    k = kpos[None, :]
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= (q >= k) | (k < prefix_len)
    if window:
        m &= ((q - k) < window) | (k < prefix_len)
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float = 0.0, prefix_len: int = 0) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, S, D) with H a multiple of KV.

    Returns (B, H, S, D) in q's type.  GQA groups the query heads by their
    kv head (a reshape, no repeat of K/V).
    """
    b, h, s, d = q.shape
    kvh = k.shape[1]
    rep = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kvh, rep, s, d)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    logits = (qg @ kf.transpose(-1, -2)) * scale          # (B, KV, rep, S, S)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    mask = visible(pos, pos, causal, window, prefix_len)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = (p @ vf) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.reshape(b, h, s, d).to(q.dtype)
