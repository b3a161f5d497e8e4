"""Mamba-2 (SSD) layer of the port: prefill through K6, O(1) decode step.

Twin of ``repro.models.ssm``.  ``ssm_block`` runs the SSD chunk scan
through ``kernels/ssd/ops.py`` in both of its branches: K6 on CUDA tensors
(with the final state when the caller wants the decode cache), the plain
``ssd_chunked_ref`` on CPU tensors.  A bf16 model hands x, B and C over as
its bf16 slices of xBC, unwidened.  ``ssm_decode_step`` is plain torch, as
the reference's is.

Under a mesh the plan splits ``in_proj``'s columns and ``out_proj``'s rows
on "model", but the block's concatenated ``[z, xBC, dt]`` output does not
split along head boundaries and its gated norm reduces over all of
``d_inner``: ``whole_params`` gathers both first, and every model rank
computes the whole block (K6 on all heads) on its data shard.  The decode
cache follows ``cache_shardings``: ``ssm_state``'s head axis on "model"
(``cache_heads``), the conv tail split on the batch only.  Prefill
stores the rank's heads of the final state; a decode step updates only
the rank's heads' state and gathers their ``y`` (B × d_inner, a few KB)
over "model" before the gated norm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import api as dist_api
from repro_torch.dist.sharding import cache_heads
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import _whole, silu


class SSMParams(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*d_inner + 2*G*N + H)
    conv_w: torch.Tensor     # (convw, d_inner + 2*G*N)  depthwise causal conv
    conv_b: torch.Tensor     # (d_inner + 2*G*N,)
    a_log: torch.Tensor      # (H,)
    d_skip: torch.Tensor     # (H,)
    dt_bias: torch.Tensor    # (H,)
    norm: torch.Tensor       # (d_inner,)
    out_proj: torch.Tensor   # (d_inner, d)


class SSMCache(NamedTuple):
    conv: torch.Tensor       # (B, convw-1, conv_dim)
    state: torch.Tensor      # (B, H, N, P) f32


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_in = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, cfg.ssm_heads], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gain: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y * silu(z)
    g32 = g.float()
    scale = torch.rsqrt((g32 * g32).mean(-1, keepdim=True) + eps)
    return (g32 * scale * (1.0 + gain.float())).to(y.dtype)


def whole_params(p: SSMParams, cfg) -> SSMParams:
    """``p`` with ``in_proj`` and ``out_proj`` whole (gathered over "model"
    where the plan split them; as they are otherwise)."""
    d_proj = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    return p._replace(in_proj=_whole(p.in_proj, d_proj, -1),
                      out_proj=_whole(p.out_proj, cfg.d_inner, 0))


def ssm_block(x: torch.Tensor, p: SSMParams, cfg, return_cache: bool = False):
    """Prefill forward. x (B, S, d) -> (B, S, d) [, SSMCache]; the cache's
    state holds the heads of ``cache_heads``."""
    bsz, s, _ = x.shape
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    p = whole_params(p, cfg)
    z, xs, b, c, dt = _split_proj(cfg, x @ p.in_proj)

    xbc_raw = torch.cat([xs, b, c], dim=-1)              # (B, S, conv_dim)
    convw = p.conv_w.shape[0]
    pad = F.pad(xbc_raw, (0, 0, convw - 1, 0))
    # depthwise causal conv as a sum of shifted slices, in the reference's
    # order (each step rounds in the compute type)
    out = torch.zeros_like(xbc_raw)
    for i in range(convw):
        out = out + pad[:, i:i + s] * p.conv_w[i]
    xbc = silu(out + p.conv_b)

    d_in = cfg.d_inner
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    xs, b, c = xs.reshape(bsz, s, h, pdim), b.reshape(bsz, s, g, n), c.reshape(bsz, s, g, n)
    if xs.dtype != torch.bfloat16:
        # bf16 views go to the scan as they are (K6 reads them in place, the
        # plain version widens them); other types are widened here.
        xs, b, c = (t.float().contiguous() for t in (xs, b, c))
    dt = _softplus(dt.float() + p.dt_bias).contiguous()   # (B, S, H)
    a = -torch.exp(p.a_log.float())
    res = ssd_ops.ssd_forward(xs, dt, a, b, c, p.d_skip.float(),
                              chunk=min(cfg.ssd_chunk, s), return_state=return_cache)
    y, h_fin = res if return_cache else (res, None)
    y = y.to(x.dtype).reshape(bsz, s, d_in)
    y = _gated_norm(y, z, p.norm, cfg.norm_eps)
    out_proj = y @ p.out_proj
    if return_cache:
        # the conv cache holds the RAW (pre-activation) xBC tail, the
        # window of ssm_decode_step
        conv_tail = xbc_raw[:, s - (convw - 1):s] if convw > 1 else xbc_raw[:, :0]
        lo, n_loc = cache_heads(h)
        return out_proj, SSMCache(conv=conv_tail, state=h_fin[:, lo:lo + n_loc])
    return out_proj


def ssm_cache_init(cfg, batch: int, dtype, device=None) -> SSMCache:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                          dtype=torch.float32, device=device))


def ssm_decode_step(x: torch.Tensor, p: SSMParams, cache: SSMCache, cfg
                    ) -> tuple[torch.Tensor, SSMCache]:
    """One-token decode. x (B, 1, d) -> (B, 1, d); O(1) state update of the
    heads that ``cache.state`` holds (``cache_heads``), their y gathered
    over "model" where the plan split them."""
    bsz = x.shape[0]
    h, pdim, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    p = whole_params(p, cfg)
    z, xs, b, c, dt = _split_proj(cfg, x[:, 0] @ p.in_proj)

    xbc = torch.cat([xs, b, c], dim=-1)                  # (B, conv_dim)
    window = torch.cat([cache.conv, xbc[:, None]], dim=1)   # (B, convw, ·)
    conv_out = (window.float() * p.conv_w.float()).sum(1).to(window.dtype) + p.conv_b
    xbc = silu(conv_out)
    new_conv = window[:, 1:]

    d_in = cfg.d_inner
    lo, h_loc = cache_heads(h)
    heads = slice(lo, lo + h_loc)
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, h, pdim)[:, heads]
    rep = h // g
    b = b.reshape(bsz, g, n).repeat_interleave(rep, dim=1)[:, heads]   # (B, H_loc, N)
    c = c.reshape(bsz, g, n).repeat_interleave(rep, dim=1)[:, heads]
    dt = _softplus(dt.float() + p.dt_bias)[:, heads]      # (B, H_loc)
    a = -torch.exp(p.a_log.float())[heads]

    decay = torch.exp(dt * a)[..., None, None]            # (B, H_loc, 1, 1)
    upd = dt[..., None, None] * b[..., None] * xs[:, :, None, :]
    state = cache.state * decay + upd                     # (B, H_loc, N, P)
    y = torch.einsum("bhn,bhnp->bhp", c.float(), state)
    y = y + p.d_skip[heads][None, :, None] * xs
    y = y.reshape(bsz, h_loc * pdim).to(x.dtype)
    if h_loc != h:
        y = dist_api.all_gather(y, "model", 1)
    y = _gated_norm(y, z, p.norm, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None]
    return out, SSMCache(conv=new_conv, state=state)
