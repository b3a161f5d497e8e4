"""Transformer building blocks of the port: norms, RoPE, attention, MLP.

Twins of ``repro.models.layers`` as plain functions over explicit parameter
tuples.  Attention routes to ``kernels/attention/ops.py``: K5 on CUDA
tensors, its plain version on CPU tensors, with ``chunked_attention``'s
semantics (the layer window and ``prefix_len`` included).

Under a mesh (``repro_torch.dist.api.use_mesh``; the parameters sliced by
``dist.sharding.shard_model``) the blocks run tensor-parallel on "model",
with Megatron's f and g (``copy_to`` / ``reduce_from``) where the ranks'
parts meet: ``_attention_sharded`` takes each rank's h/mp query heads and
the contiguous kv-head slice they read (K5 on those heads), the row-split
``wo`` ends in one sum over "model"; ``mlp_block`` is column- then
row-parallel; ``moe_block``'s mesh branch is expert-parallel (each data
shard routes its own tokens, each model rank computes its run of the
e_pad padded experts, the combine is one sum over "model" in the compute
type, aux the mean over the data axes).  A weight that a layer cannot use
split (the reference's fallbacks) is gathered first: every rank then
computes the same thing.  Serving keeps the decode cache as
``cache_shardings`` places it (``sharding.cache_heads``): prefill's
attention hands over the k and v of the cache's heads, and
``attention_decode`` is the one-token mirror of ``_attention_sharded``,
reading the rank's kv heads from the cache (its own where the plan splits
them, its slice of a replicated cache; on the fallback the cache is
gathered for the layer).

bf16 arithmetic follows the reference op by op: ``silu`` is ``x *
sigmoid(x)``, two roundings, as ``jax.nn.silu`` is written.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.dist import api as dist_api
from repro_torch.dist.sharding import cache_heads, expert_range, split_on
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


def _head_split(cfg) -> tuple[int, int, int] | None:
    """(h_loc, kv_loc, start) of the head-parallel attention on the current
    mesh's "model" axis (the reference's shard_map): rank m computes its
    h/mp query heads and the contiguous kv heads they read, ``start =
    m·h_loc·kvh // h`` and ``kv_loc = max(1, h_loc // group)``.  None where
    the reference falls back (no mesh, mp 1, h % mp, a slice that is not
    contiguous)."""
    if dist_api.current() is None:
        return None
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    mp = dist_api.axis_size("model")
    if mp == 1 or h % mp:
        return None
    h_loc = h // mp
    group = h // kvh                    # q heads per kv head
    kv_loc = max(1, h_loc // group)
    if h_loc % kv_loc or not (group % h_loc == 0 or h_loc % group == 0):
        return None
    return h_loc, kv_loc, (dist_api.axis_index("model") * h_loc * kvh) // h


def _kv_cols(w: torch.Tensor, cfg, count: int, first: int) -> torch.Tensor:
    """The columns of kv heads ``first`` .. ``first + count`` - 1 of wk / wv
    on this rank: its own slice where the plan's is exactly those heads,
    else cut from the whole weight (gathered where the plan split it)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    midx = dist_api.axis_index("model")
    if split_on(w, kvh * hd) and w.shape[-1] == count * hd and first == midx * count:
        return w                        # the plan's slice is these heads
    full = (dist_api.gather_shards(w, "model", w.dim() - 1) if split_on(w, kvh * hd)
            else dist_api.copy_to(w, "model"))
    return full[:, first * hd:(first + count) * hd]


def _rank_kv(xin: torch.Tensor, p: AttnParams, positions: torch.Tensor, cfg,
             kv_loc: int, start: int, cache: bool = True) -> tuple:
    """The head-parallel attention's keys and values on this rank: (k, v)
    (B, S, kv_loc, hd) of the kv heads its query heads read (k rotated), and
    (k, v) of the heads its decode cache holds (``cache_heads``).  Where
    the cache plan splits the kv heads the two are the same heads; where it
    replicates them (kvh not a multiple of mp) the rank projects every kv
    head for its cache and the attention takes its slice of them.  Without
    ``cache`` (training) only the attention's heads are projected."""
    b, s, _ = xin.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    lo, n = cache_heads(kvh) if cache else (start, kv_loc)
    first, count = (start, kv_loc) if (lo, n) == (start, kv_loc) else (0, kvh)
    k = apply_rope((xin @ _kv_cols(p.wk, cfg, count, first)).reshape(b, s, count, hd),
                   positions, cfg.rope_theta)
    v = (xin @ _kv_cols(p.wv, cfg, count, first)).reshape(b, s, count, hd)

    def heads(a, lo_, n_):
        return a[:, :, lo_ - first:lo_ - first + n_]
    return ((heads(k, start, kv_loc), heads(v, start, kv_loc)),
            (heads(k, lo, n), heads(v, lo, n)))


def _attention_sharded(x: torch.Tensor, p: AttnParams, positions: torch.Tensor, cfg,
                       layer_window: int, prefix_len: int,
                       kv_out: list | None = None) -> torch.Tensor | None:
    """Head-parallel attention on the current mesh's "model" axis
    (``_head_split``): the rank's query heads and the kv heads they read
    through K5, then its rows of ``wo``; one sum over "model" joins the
    ranks.  ``kv_out`` receives the (k, v) of the rank's decode cache.  None
    where the reference falls back."""
    split = _head_split(cfg)
    if split is None:
        return None
    h_loc, kv_loc, start = split
    b, s, _ = x.shape
    xin = dist_api.copy_to(x, "model")
    q = apply_rope((xin @ p.wq).reshape(b, s, h_loc, cfg.head_dim), positions,
                   cfg.rope_theta)
    (k, v), cached = _rank_kv(xin, p, positions, cfg, kv_loc, start, kv_out is not None)
    if kv_out is not None:
        kv_out.extend(cached)
    out = attn_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=layer_window, softcap=cfg.attn_softcap,
        prefix_len=prefix_len)
    return dist_api.reduce_from(out.transpose(1, 2).reshape(b, s, -1) @ p.wo, "model")


def _whole(w: torch.Tensor, full: int, dim: int) -> torch.Tensor:
    """``w`` whole along ``dim`` on every rank (a gather where the mesh
    split it on "model"; every rank then computes the same thing)."""
    return dist_api.gather_copies(w, "model", dim % w.dim()) if split_on(w, full, dim) else w


def _whole_attn(p: AttnParams, cfg) -> AttnParams:
    hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return AttnParams(_whole(p.wq, hq, -1), _whole(p.wk, hk, -1), _whole(p.wv, hk, -1),
                      _whole(p.wo, hq, 0))


def attention_block(x: torch.Tensor, p: AttnParams, positions: torch.Tensor, cfg,
                    layer_window: int = 0, prefix_len: int = 0,
                    kv_out: list | None = None) -> torch.Tensor:
    """proj -> rope -> attention (K5 on the card) -> out proj.

    ``kv_out`` receives the rotated k and the v (B, S, kv, hd) of the heads
    that the decode cache holds (prefill's cache): all of them on one
    device, the rank's ``cache_heads`` under a mesh.  Under a mesh:
    ``_attention_sharded``, or, where it falls back, the whole attention on
    every rank."""
    if dist_api.current() is not None:
        out = _attention_sharded(x, p, positions, cfg, layer_window, prefix_len, kv_out)
        if out is not None:
            return out
        p = _whole_attn(p, cfg)
    b, s, _ = x.shape
    q, k, v = qkv(x, p, positions, cfg)
    if kv_out is not None:
        lo, n = cache_heads(cfg.n_kv_heads)
        kv_out.extend((k[:, :, lo:lo + n], v[:, :, lo:lo + n]))
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


def attention_decode(x: torch.Tensor, p: AttnParams, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, cfg, window: int = 0) -> torch.Tensor:
    """One token's attention sub-block: x (B, 1, d) normed -> (B, 1, d).
    Writes the token's rotated k and its v at ``pos`` of the caches (B, Smax,
    kv, hd) in place; they hold the heads of ``cache_heads``.

    Under a mesh where the attention is head-parallel (``_head_split``), the
    one-token mirror of ``_attention_sharded``: the rank's query heads
    against its kv heads of the cache (the cache's own heads where the plan
    splits them, its slice of a replicated cache), ``decode_attention``'s
    window and softcap, its rows of ``wo``, one sum over "model".
    Elsewhere every head on every rank, the cache gathered over "model" for
    the layer where the plan split it."""
    b = x.shape[0]
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    cur = torch.full((b,), pos + 1, dtype=torch.long, device=x.device)
    split = _head_split(cfg)
    if split is not None:
        h_loc, kv_loc, start = split
        xin = dist_api.copy_to(x, "model")
        q = apply_rope((xin @ p.wq).reshape(b, 1, h_loc, hd), positions, cfg.rope_theta)
        _, (k, v) = _rank_kv(xin, p, positions, cfg, kv_loc, start)
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        lo, _ = cache_heads(kvh)
        ks = k_cache[:, :, start - lo:start - lo + kv_loc]
        vs = v_cache[:, :, start - lo:start - lo + kv_loc]
        out = decode_attention(q, ks, vs, cur, softcap=cfg.attn_softcap, window=window)
        return dist_api.reduce_from(out.reshape(b, 1, -1) @ p.wo, "model")
    if dist_api.current() is not None:
        p = _whole_attn(p, cfg)
    q, k, v = qkv(x, p, positions, cfg)
    lo, n = cache_heads(kvh)
    k_cache[:, pos] = k[:, 0, lo:lo + n].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0, lo:lo + n].to(v_cache.dtype)
    ks, vs = k_cache, v_cache
    if n != kvh:                        # the plan split the cache's kv heads
        ks = dist_api.all_gather(k_cache, "model", 2)
        vs = dist_api.all_gather(v_cache, "model", 2)
    out = decode_attention(q, ks, vs, cur, softcap=cfg.attn_softcap, window=window)
    return out.reshape(b, 1, -1) @ p.wo


class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (d, ff)
    w_up: torch.Tensor     # (d, ff)
    w_down: torch.Tensor   # (ff, d)


def mlp_block(x: torch.Tensor, p: MLPParams, ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  Under a mesh that split its hidden width ``ff`` on "model":
    column-parallel ``w_gate``/``w_up``, row-parallel ``w_down``, one sum."""
    if ff is not None and split_on(p.w_gate, ff):
        xin = dist_api.copy_to(x, "model")
        h = silu(xin @ p.w_gate) * (xin @ p.w_up)
        return dist_api.reduce_from(h @ p.w_down, "model")
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


def _moe_local_chunk(xf: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                     wu: torch.Tensor, wd: torch.Tensor, top_k: int, cap: int,
                     first: int, end: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch, compute and combine for one token chunk xf (T, d), of the
    experts ``first`` .. ``end``-1, whose weights wg/wu (n, d, ffe) and wd
    (n, ffe, d) are given: the reference's ``_moe_local_chunk`` (one rank's
    part on a mesh; all E experts, the single-device dispatch).

    The tokens are routed over every expert.  The reference's slot layout:
    choices sorted stably by expert, the first ``cap`` of each expert kept
    at ``expert * cap + rank``, the rest (and other ranks' experts) sent to
    a trash slot that is never read back.  The reference pads E to a
    multiple of ``expert_pad`` (16) and computes the padded experts on zero
    rows; here only the real experts are computed and the trash slot
    follows them, which gives the same output.  The expert products take
    the compute-type operands widened to f32 (exact) into an f32 product, as
    ``preferred_element_type=f32`` has them; on the card that needs TF32 off
    (PyTorch's default).  Returns the partial output (every token's rows of
    these experts, combined as ``combine_top_k`` does) and the aux loss.
    On a mesh the gates and the dispatched tokens pass ``copy_to``: each
    rank's part of their gradient meets in one sum over "model", and the
    aux term reads the routing probabilities alike on every rank.  Nothing
    here reads a value back to the host, and the combine uses no atomics:
    on the card two runs give the same bits."""
    t, d = xf.shape
    e = router.shape[-1]
    n = end - first
    dev = xf.device
    probs = torch.softmax((xf @ router).float(), dim=-1)               # (T, E)
    # lax.top_k takes the lower expert first among equal gates, and a stable
    # descending sort does too (torch.topk leaves that order unspecified).
    # Under bf16 the router logits are rounded to 8 bits, so equal gates
    # are common.
    gate_vals, gate_idx = torch.sort(dist_api.copy_to(probs, "model"), dim=-1,
                                     descending=True, stable=True)
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
    keep = (se >= first) & (se < end) & (pos < cap)
    slot = torch.where(keep, (se - first) * cap + pos, torch.full_like(se, n * cap))

    # token t's k copies (an expand, whose gradient is a sum, not atomics)
    # in sorted order
    xs = dist_api.copy_to(xf, "model")[:, None].expand(t, top_k, d).reshape(t * top_k, d)
    xs = xs[order]
    buf = torch.zeros((n * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xs, torch.zeros((), dtype=xf.dtype, device=dev))
    buf = buf[:-1].reshape(n, cap, d).float()
    hgate = torch.bmm(buf, wg.float())
    hup = torch.bmm(buf, wu.float())
    hout = torch.bmm(silu(hgate) * hup, wd.float()).to(xf.dtype)

    yflat = torch.cat([hout.reshape(n * cap, d), torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    gathered = yflat[slot] * (sw * keep)[:, None].to(xf.dtype)
    return combine_top_k(gathered, order, gate_idx), aux


def _moe_mesh(x: torch.Tensor, p: MoEParams, top_k: int, capacity_factor: float,
              tokens_per_chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's mesh branch of ``moe_block``: x (B_loc, S, d) is this
    data shard's; each model rank holds its run of the e_pad padded experts
    (the real ones: ``sharding.expert_range``, gathered from FSDP by the
    caller).  Tokens are routed in chunks of the local count
    (``n_chunk``/``tc``/``cap`` from it), the partial outputs summed over
    "model" in the compute type, aux averaged over the chunks and the data
    axes."""
    b, s, d = x.shape
    e = p.router.shape[-1]
    mp = dist_api.axis_size("model")
    _, first, end = expert_range(e, mp, dist_api.axis_index("model"))
    if p.w_gate.shape[0] != end - first:
        raise ValueError(f"rank holds {p.w_gate.shape[0]} experts, the mesh gives it "
                         f"{end - first}: shard the model with dist.sharding.shard_model")
    t_loc = b * s
    n_chunk = max(1, t_loc // tokens_per_chunk)
    while t_loc % n_chunk:
        n_chunk += 1
    tc = t_loc // n_chunk
    cap = min(int(max(4, (tc * top_k / e) * capacity_factor)), tc)
    xf = x.reshape(t_loc, d)
    parts, auxs = [], []
    for c in range(n_chunk):
        part, aux = _moe_local_chunk(xf[c * tc:(c + 1) * tc], p.router, p.w_gate, p.w_up,
                                     p.w_down, top_k, cap, first, end)
        parts.append(part)
        auxs.append(aux)
    partial = parts[0] if n_chunk == 1 else torch.cat(parts)
    aux = auxs[0] if n_chunk == 1 else torch.stack(auxs).mean()
    out = dist_api.reduce_from(partial, "model")
    aux = dist_api.reduce_from(aux, "data") / dist_api.axis_size("data")
    return out.reshape(b, s, d), aux


def moe_block(x: torch.Tensor, p: MoEParams, top_k: int, capacity_factor: float,
              tokens_per_chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity over x (B, S, d): (out (B, S, d), aux loss).

    Without a mesh, the reference's single-device branch: every token of
    the batch in one chunk, ``cap = min(int(max(4, T k / E *
    capacity_factor)), T)``.  Under one, ``_moe_mesh``."""
    if dist_api.current() is not None:
        return _moe_mesh(x, p, top_k, capacity_factor, tokens_per_chunk)
    b, s, d = x.shape
    e = p.router.shape[-1]
    t = b * s
    cap = min(int(max(4, (t * top_k / e) * capacity_factor)), t)
    out, aux = _moe_local_chunk(x.reshape(t, d), p.router, p.w_gate, p.w_up, p.w_down,
                                top_k, cap, 0, e)
    return out.reshape(b, s, d), aux
