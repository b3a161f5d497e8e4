"""Model assembly of the port: init, forward, prefill and decode for every family.

Twin of ``repro.models.transformer.Model`` as an ``nn.Module``.  The
reference stacks every per-layer leaf along a leading (L,) axis and scans;
here each layer is a submodule of its own and the scan is a Python loop.

  dense   — attention + SwiGLU MLP                 (gemma2, mistral, llama3,
            deepseek-coder; gemma2's even layers are local, window 4096)
  moe     — attention + top-k MoE (+ arctic's parallel dense FFN)
  ssm     — Mamba-2 SSD blocks only                (mamba2)
  hybrid  — Mamba-2 blocks + ONE shared attention+MLP block applied after
            every layer idx with (idx + 1) % shared_attn_every == 0
            (zamba2; its weights are reused at each application, with a
            KV cache slot per application)
  encoder — bidirectional attention blocks over projected audio frames
            (hubert); served through ``forward_logits``, no decode
  vlm     — projected patches prepended to the text, prefix-LM mask
            (paligemma)

Every attention runs through ``layers.attention_block``: K5 on the card,
its plain version on the CPU.  Prefill fills each layer's KV cache from
the projections its attention used; decode attends over the cache in plain
torch (``layers.attention_decode``), as the reference does.

Parameters are kept in ``param_dtype`` (f32 masters).  Like the
reference's ``_cast_tree``, every float parameter enters the compute in
``compute_dtype`` — ``a_log``, ``d_skip`` and ``dt_bias`` included, which
under bf16 rounds them before ``ssm_block`` widens them again.  Serving
(no gradient) makes the cast copies once, at the first forward, and keeps
them (the cast is exact to repeat); ``init`` and ``weights_changed`` drop
them.  Serving updates the cache dict in place.

Training (``loss_fn`` with grad mode on and the parameters requiring grad,
see ``trainable``) casts inside autograd on every forward instead: a
layer's weights inside its own body, so that under ``remat == "block"``
(one ``torch.utils.checkpoint`` a layer, zamba2's shared block inside the
body of the layer it follows, as in the reference's scan body) the casts
are recomputed with the rest.  MoE's aux loss is summed over the layers.
The loss is the reference's: ``chunked_ce`` over ``loss_chunk`` positions
at a time, each chunk checkpointed (the (B, S, V) logits never exist at
once), plus 0.01 aux.  K5 and K6 run in the forward (and again in each
recompute); their backward is their plain versions' gradient
(``kernels/*/ops.py``).

Under a mesh (``with dist_api.use_mesh(mesh): model.loss_fn(batch)``, the
model sliced by ``dist.sharding.shard_model`` and ``batch`` the rank's rows,
``sharding.shard_batch``) each cast weight passes
``sharding.layer_weight`` (FSDP's gather) and the layers run
tensor-parallel (``layers.py``).  The embedding and the head are
vocab-parallel where the plan split the vocab (the lookup, the logsumexp
and the gold logit each end in a sum over "model"), and ``chunked_ce`` is
the GLOBAL mean: the loss sums and counts are summed over "data" before
the division.  Each rank's loss is then the global loss, and its backward
gives the rank's share of the global gradient: ``train.step`` sums them
over "data".  The mesh is captured where a checkpointed body starts and set
again inside it, so that a recompute in the backward (on the autograd
engine's own thread on the card) runs on the same mesh.

Serving under a mesh (``with dist_api.use_mesh(mesh): model.prefill(batch,
max_len)``, then ``model.decode_step(cache, tokens)``): ``prefill`` takes
the global batch and computes on the rank's rows (``sharding.shard_batch``);
its cache is the rank's part of ``cache_shardings``' plan (``cache_init``:
the batch on "data", kv heads and ``ssm_state``'s heads on "model" where
they divide), and ``decode_step`` takes the rank's tokens (B_loc, 1), as
the logits of both are the rank's data shard's, whole over the vocabulary
(gathered where the head is vocab-split).  The attention is head-parallel
(K5 on the rank's heads in prefill, ``attention_decode`` on them in
decode), the MLP and the MoE as in training, the SSM blocks whole on every
rank with the state's heads split (``models/ssm.py``).  Serving keeps the
SSM blocks' gathered ``in_proj`` / ``out_proj`` with its cast copies.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._lazy_import import import_dynamo_aside
from repro_torch.dist import api as dist_api, sharding
from repro_torch.dist.sharding import split_on
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnParams, MLPParams, MoEParams, attention_block,
                                       attention_decode, mlp_block, moe_block, rms_norm)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")
ATTN_FAMILIES = ("dense", "moe", "encoder", "vlm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class SSMLayer(nn.Module):
    """One Mamba-2 layer: its pre-norm gain and ``SSMParams``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, d_in = cfg.d_model, cfg.d_inner
        gn = cfg.ssm_groups * cfg.ssm_state
        heads = cfg.ssm_heads
        self.ln1 = _param((d,), dtype, device)
        self.in_proj = _param((d, 2 * d_in + 2 * gn + heads), dtype, device)
        self.conv_w = _param((cfg.ssm_conv, d_in + 2 * gn), dtype, device)
        self.conv_b = _param((d_in + 2 * gn,), dtype, device)
        self.a_log = _param((heads,), torch.float32, device)
        self.d_skip = _param((heads,), torch.float32, device)
        self.dt_bias = _param((heads,), torch.float32, device)
        self.norm = _param((d_in,), dtype, device)
        self.out_proj = _param((d_in, d), dtype, device)


class Experts(nn.Module):
    """A layer's ``MoEParams``: the router and the stacked expert weights."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, e, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff
        self.router = _param((d, e), dtype, device)
        self.w_gate = _param((e, d, ffe), dtype, device)
        self.w_up = _param((e, d, ffe), dtype, device)
        self.w_down = _param((e, ffe, d), dtype, device)


class AttnBlock(nn.Module):
    """Pre-norm attention, then a SwiGLU MLP of width ``ff`` and/or top-k
    experts: a layer of the attention families, and zamba2's shared block."""

    def __init__(self, cfg: ModelConfig, dtype, device, ff: int, moe: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.ln1 = _param((d,), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self.wq = _param((d, cfg.n_heads * hd), dtype, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _param((cfg.n_heads * hd, d), dtype, device)
        self.has_mlp = ff > 0
        if self.has_mlp:
            self.w_gate = _param((d, ff), dtype, device)
            self.w_up = _param((d, ff), dtype, device)
            self.w_down = _param((ff, d), dtype, device)
        self.moe = Experts(cfg, dtype, device) if moe else None


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.attention = cfg.family in ATTN_FAMILIES
        pd = _dtype(cfg.param_dtype)
        d = cfg.d_model
        self.embed = _param((cfg.vocab, d), pd, self.device)
        self.final_norm = _param((d,), pd, self.device)
        self.head = None if cfg.tie_embeddings else _param((d, cfg.vocab), pd, self.device)
        if self.attention:
            moe = cfg.family == "moe"
            ff = cfg.moe_dense_ff if moe else cfg.d_ff
            self.layers = nn.ModuleList(AttnBlock(cfg, pd, self.device, ff, moe)
                                        for _ in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(SSMLayer(cfg, pd, self.device)
                                        for _ in range(cfg.n_layers))
        self.shared = (AttnBlock(cfg, pd, self.device, cfg.d_ff)
                       if cfg.family == "hybrid" and cfg.shared_attn_every else None)
        self.vision_proj = (_param((cfg.frontend_dim, d), pd, self.device)
                            if cfg.frontend == "vision_stub" else None)
        audio = cfg.frontend == "audio_stub"
        self.frontend_proj = _param((cfg.frontend_dim, d), pd, self.device) if audio else None
        self.mask_emb = _param((d,), pd, self.device) if audio else None
        self._cw = None
        # set by dist.sharding.shard_model: name -> Placement, and the mesh's sizes
        self.placement = None
        self.placement_mesh = None
        self._pl_of = None

    # ------------------------------------------------------------------ #
    # init                                                               #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` with the reference's
        distributions (``transformer.py`` ``Model.init``): matrices normal
        times shape[-2]^-1/2 (the embedding and ``mask_emb`` 0.02), gains
        and biases zero, ``a_log = log(linspace(1, 16, H))``, ``d_skip``
        one, and ``dt_bias`` the inverse softplus of exp(uniform(log 1e-3,
        log 1e-1))."""
        cfg = self.cfg
        gdev = generator.device

        def normal(p: nn.Parameter, scale: float):
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev) * scale)

        def mat(p: nn.Parameter):
            normal(p, p.shape[-2] ** -0.5)

        normal(self.embed, 0.02)
        for p in (self.head, self.vision_proj, self.frontend_proj):
            if p is not None:
                mat(p)
        if self.mask_emb is not None:
            normal(self.mask_emb, 0.02)
        heads = cfg.ssm_heads
        lo, hi = math.log(1e-3), math.log(1e-1)
        for layer in self.layers:
            if isinstance(layer, AttnBlock):
                self._init_block(layer, mat)
                continue
            mat(layer.in_proj)
            normal(layer.conv_w, cfg.ssm_conv ** -0.5)
            mat(layer.out_proj)
            layer.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, heads)))
            layer.d_skip.fill_(1.0)
            dt0 = torch.exp(torch.rand(heads, generator=generator, device=gdev)
                            * (hi - lo) + lo)
            layer.dt_bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
            for gain in (layer.ln1, layer.conv_b, layer.norm):
                gain.zero_()
        if self.shared is not None:
            self._init_block(self.shared, mat)
        self.final_norm.zero_()
        self._cw = None
        return self

    @staticmethod
    def _init_block(block: AttnBlock, mat) -> None:
        names = list(AttnParams._fields) + (list(MLPParams._fields) if block.has_mlp else [])
        for w in names:
            mat(getattr(block, w))
        if block.moe is not None:
            for w in MoEParams._fields:
                mat(getattr(block.moe, w))
        block.ln1.zero_()
        block.ln2.zero_()

    def trainable(self) -> "Model":
        """Make every parameter require grad: a forward under grad mode then
        casts inside autograd and can be differentiated."""
        self.requires_grad_(True)
        self._cw = None
        return self

    def weights_changed(self) -> None:
        """Drop the serving cast copies: the parameters were updated."""
        self._cw = None

    def _differentiated(self) -> bool:
        return torch.is_grad_enabled() and self.embed.requires_grad

    def _cast(self, p):
        """``p`` in the compute type, inside autograd (a view where it is one),
        as the layer computes from it on the mesh (``_placed``)."""
        return None if p is None else self._placed(p.to(_dtype(self.cfg.compute_dtype)), p)

    def _placed(self, t, p):
        """``t`` (parameter ``p`` cast) with FSDP's gather where the mesh
        split ``p`` on the data axes."""
        if self.placement is None:
            return t
        if self._pl_of is None:
            self._pl_of = {id(q): self.placement[n] for n, q in self.named_parameters()}
        return sharding.layer_weight(t, self._pl_of[id(p)])

    def _check_mesh(self) -> None:
        mesh = dist_api.current()
        if self.placement is not None:
            if mesh is None or dict(mesh.shape) != self.placement_mesh:
                raise ValueError(f"the model is sharded for the mesh {self.placement_mesh}; "
                                 "run it inside dist.api.use_mesh of that mesh")
        elif mesh is not None and mesh.size > 1:
            raise ValueError("a model runs on a mesh once dist.sharding.shard_model has "
                             "given each rank its slices")

    def weights(self) -> SimpleNamespace:
        """Every parameter in the compute type (``_cast_tree``).  Serving:
        made once and kept.  Training: the top-level weights cast anew on
        each call, inside autograd, with ``layers`` and ``shared`` None (the
        backbone casts a layer's weights inside its body)."""
        if self._differentiated():
            return self._weights(self._cast, layers=False)
        if self._cw is None:
            cd = _dtype(self.cfg.compute_dtype)
            self._cw = self._weights(
                lambda p: None if p is None else self._placed(p.detach().to(cd), p))
            if self.placement is not None and not self.attention:
                # the SSM blocks compute from whole projections: gather once
                self._cw.layers = [(ln1, ssm_mod.whole_params(sp, self.cfg))
                                   for ln1, sp in self._cw.layers]
        return self._cw

    def _weights(self, c, layers: bool = True) -> SimpleNamespace:
        return SimpleNamespace(
            embed=c(self.embed), final_norm=c(self.final_norm),
            head=c(self.embed).T if self.head is None else c(self.head),
            layers=[self._layer_weights(lay, c) for lay in self.layers] if layers else None,
            shared=(None if self.shared is None or not layers
                    else self._block_weights(self.shared, c)),
            vision_proj=c(self.vision_proj), frontend_proj=c(self.frontend_proj),
            mask_emb=c(self.mask_emb))

    def _layer_weights(self, layer, c):
        if isinstance(layer, AttnBlock):
            return self._block_weights(layer, c)
        return (c(layer.ln1), ssm_mod.SSMParams(
            *(c(getattr(layer, f)) for f in ssm_mod.SSMParams._fields)))

    @staticmethod
    def _block_weights(block: AttnBlock, c) -> SimpleNamespace:
        return SimpleNamespace(
            ln1=c(block.ln1), ln2=c(block.ln2),
            attn=AttnParams(*(c(getattr(block, f)) for f in AttnParams._fields)),
            mlp=MLPParams(*(c(getattr(block, f)) for f in MLPParams._fields))
            if block.has_mlp else None,
            moe=None if block.moe is None else MoEParams(
                *(c(getattr(block.moe, f)) for f in MoEParams._fields)))

    # ------------------------------------------------------------------ #
    # embedding / unembedding                                            #
    # ------------------------------------------------------------------ #
    def embed_tokens(self, tokens: torch.Tensor, w: SimpleNamespace | None = None
                     ) -> torch.Tensor:
        emb = (w or self.weights()).embed
        # the reference multiplies by a weakly typed scalar: it is rounded
        # to the compute type first
        scale = torch.tensor(self.cfg.d_model ** 0.5, dtype=emb.dtype)
        if split_on(emb, self.cfg.vocab, 0):
            # vocab-parallel: each rank looks up the tokens of its rows
            v_loc = emb.shape[0]
            ids = tokens - dist_api.axis_index("model") * v_loc
            mine = ((ids >= 0) & (ids < v_loc))[..., None]
            rows = torch.where(mine, emb[ids.clamp(0, v_loc - 1)],
                               torch.zeros((), dtype=emb.dtype, device=emb.device))
            return dist_api.reduce_from(rows, "model") * scale
        return emb[tokens] * scale

    def embed_inputs(self, batch: dict) -> tuple[torch.Tensor, int]:
        """(x (B, S, d), prefix_len) through the modality frontend: audio
        ``frames`` (B, S, frontend_dim) projected, ``mask_emb`` where
        ``mask_indices``; or ``patches`` (B, P, frontend_dim) projected and
        prepended to the ``tokens``' embeddings, all P of them a prefix."""
        cfg, w = self.cfg, self.weights()
        if cfg.frontend == "audio_stub":
            x = batch["frames"].to(w.frontend_proj.dtype) @ w.frontend_proj
            if "mask_indices" in batch:
                x = torch.where(batch["mask_indices"][..., None], w.mask_emb, x)
            return x, 0
        if cfg.frontend == "vision_stub":
            vis = batch["patches"].to(w.vision_proj.dtype) @ w.vision_proj
            return (torch.cat([vis, self.embed_tokens(batch["tokens"], w)], dim=1),
                    cfg.n_prefix_tokens)
        return self.embed_tokens(batch["tokens"], w), 0

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """x @ head in f32 with the final softcap: the rank's vocab columns
        where the plan split the head."""
        cfg = self.cfg
        head = self.weights().head
        if split_on(head, cfg.vocab):
            x = dist_api.copy_to(x, "model")
        out = (x @ head).float()
        if cfg.final_softcap > 0:
            out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
        return out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        out = self._head(x)
        if out.shape[-1] != self.cfg.vocab:
            out = dist_api.gather_copies(out, "model", out.dim() - 1)
        return out

    # ------------------------------------------------------------------ #
    # forward                                                            #
    # ------------------------------------------------------------------ #
    def layer_window(self, idx: int) -> int:
        """Layer ``idx``'s attention window (0 global): gemma2 is local on
        the even layers (``_layer_windows``)."""
        cfg = self.cfg
        if cfg.alt_local_global:
            return cfg.window if idx % 2 == 0 else 0
        return cfg.window

    def _applies_shared(self, idx: int) -> bool:
        every = self.cfg.shared_attn_every
        return self.shared is not None and bool(every) and (idx + 1) % every == 0

    def _ffn(self, h, blk):
        """The block's feed-forward on its normed input: MLP, or MoE plus
        arctic's parallel dense MLP.  Returns (out, MoE's aux loss or None)."""
        cfg = self.cfg
        if blk.moe is None:
            return mlp_block(h, blk.mlp, cfg.d_ff), None
        out, aux = moe_block(h, blk.moe, cfg.top_k, cfg.capacity_factor)
        return (out if blk.mlp is None else out + mlp_block(h, blk.mlp, cfg.moe_dense_ff)), aux

    def _attn_block(self, x, blk, positions, window, prefix_len, kv_out=None):
        """Attention (K5 on the card) and feed-forward with their residuals:
        (x, aux or None); ``kv_out`` receives the (k, v) of the heads the
        decode cache holds (prefill's cache)."""
        cfg = self.cfg
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        x = x + attention_block(h, blk.attn, positions, cfg, window, prefix_len, kv_out=kv_out)
        out, aux = self._ffn(rms_norm(x, blk.ln2, cfg.norm_eps), blk)
        return x + out, aux

    def _layer(self, idx, lw, shared, x, positions, prefix_len, cache=None):
        """Layer ``idx`` with weights ``lw``, then the shared block (weights
        ``shared``) where it applies: (x, aux or None).  With ``cache``, also
        fills the layer's KV slots, SSD state and conv tail (prefill)."""
        cfg = self.cfg
        s = x.shape[1]
        kv: list | None = None if cache is None else []
        if self.attention:
            x, aux = self._attn_block(x, lw, positions, self.layer_window(idx), prefix_len, kv)
            if cache is not None:
                cache["k"][idx, :, :s], cache["v"][idx, :, :s] = kv
            return x, aux
        ln1, p = lw
        h = rms_norm(x, ln1, cfg.norm_eps)
        if cache is None:
            x = x + ssm_mod.ssm_block(h, p, cfg)
        else:
            out, sc = ssm_mod.ssm_block(h, p, cfg, return_cache=True)
            x = x + out
            cache["ssm_conv"][idx] = sc.conv
            cache["ssm_state"][idx] = sc.state
        if self._applies_shared(idx):
            x, _ = self._attn_block(x, shared, positions, 0, prefix_len, kv)
            if cache is not None:
                app = (idx + 1) // cfg.shared_attn_every - 1
                cache["shared_k"][app, :, :s], cache["shared_v"][app, :, :s] = kv
        return x, None

    def _train_layer(self, idx, x, positions, prefix_len, mesh=None):
        """Layer ``idx`` under autograd, on ``mesh``: its weights (and the
        shared block's where it applies) cast here, so that a checkpoint
        recomputes them.  Returns (x, aux) with aux a tensor (0 without MoE)."""
        with dist_api.use_mesh(mesh):
            layer = self.layers[idx]
            lw = self._layer_weights(layer, self._cast)
            shared = (self._block_weights(self.shared, self._cast)
                      if self._applies_shared(idx) else None)
            x, aux = self._layer(idx, lw, shared, x, positions, prefix_len)
        return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux

    def backbone(self, x: torch.Tensor, positions: torch.Tensor, prefix_len: int = 0,
                 cache: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Every layer in order. Returns (the final-normed hidden (B, S, d),
        the aux loss summed over the layers, f32); with ``cache``, also fills
        its KV slots, SSD states and conv tails (prefill).  Differentiated
        (see ``trainable``), each layer casts its own weights and, under
        ``remat == "block"``, runs under one activation checkpoint."""
        cfg = self.cfg
        self._check_mesh()
        mesh = dist_api.current()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self._differentiated():
            if cache is not None:
                raise ValueError("prefill fills a cache without gradients")
            if cfg.remat == "block":
                import_dynamo_aside()     # before checkpoint's first call
            for idx in range(cfg.n_layers):
                if cfg.remat == "block":
                    x, a = checkpoint(self._train_layer, idx, x, positions, prefix_len, mesh,
                                      use_reentrant=False)
                else:
                    x, a = self._train_layer(idx, x, positions, prefix_len, mesh)
                aux = aux + a
            return rms_norm(x, self.weights().final_norm, cfg.norm_eps), aux
        w = self.weights()
        for idx, lw in enumerate(w.layers):
            x, a = self._layer(idx, lw, w.shared, x, positions, prefix_len, cache)
            if a is not None:
                aux = aux + a
        return rms_norm(x, w.final_norm, cfg.norm_eps), aux

    @torch.no_grad()
    def forward_logits(self, batch: dict) -> torch.Tensor:
        """Full-sequence logits (B, S, V) f32 (vlm: the patch prefix's too)."""
        x, prefix_len = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        return self.logits(self.backbone(x, positions, prefix_len)[0])

    # ------------------------------------------------------------------ #
    # losses                                                             #
    # ------------------------------------------------------------------ #
    def _chunk_loss(self, h: torch.Tensor, labels: torch.Tensor, mesh=None):
        """(sum of -log p(label), count) over one chunk; label -1 ignored.
        Where the head is vocab-split on ``mesh``: the max, the sum of exps
        and the gold logit over the rank's columns, each joined over "model"."""
        with dist_api.use_mesh(mesh):
            logits = self._head(h)                                # (B, cs, V_loc) f32
            valid = (labels >= 0).float()
            lab = labels.clamp(min=0)
            v_loc = logits.shape[-1]
            if v_loc == self.cfg.vocab:
                logz = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, lab[..., None])[..., 0]
            else:
                m = dist_api.pmax(logits.detach().amax(-1), "model")
                sumexp = dist_api.reduce_from(torch.exp(logits - m[..., None]).sum(-1), "model")
                logz = m + torch.log(sumexp)
                ids = lab - dist_api.axis_index("model") * v_loc
                mine = (ids >= 0) & (ids < v_loc)
                gold = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
                gold = dist_api.reduce_from(torch.where(mine, gold, torch.zeros_like(gold)),
                                            "model")
            return torch.sum((logz - gold) * valid), torch.sum(valid)

    def chunked_ce(self, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the labels >= 0 (-1: padding or prefix),
        ``loss_chunk`` positions at a time (the largest divisor of S up to
        it), each chunk checkpointed under autograd: the (B, S, V) logits
        are never materialised."""
        s = hidden.shape[1]
        cs = min(self.cfg.loss_chunk, s)
        while s % cs:
            cs -= 1
        mesh = dist_api.current()
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, s, cs):
            h, lab = hidden[:, c0:c0 + cs], labels[:, c0:c0 + cs]
            if self._differentiated():
                dl, dc = checkpoint(self._chunk_loss, h, lab, mesh, use_reentrant=False)
            else:
                dl, dc = self._chunk_loss(h, lab, mesh)
            tot, cnt = tot + dl, cnt + dc
        # the global mean: sums and counts over the data shards, then divided
        tot, cnt = dist_api.reduce_from(tot, "data"), dist_api.psum(cnt, "data")
        return tot / torch.clamp(cnt, min=1.0)

    def loss_fn(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss of ``batch`` (``tokens`` or the modality's
        inputs, and ``labels`` (B, S)): (ce + 0.01 aux, {"ce", "aux"}).  vlm
        drops the patch prefix from the hidden states; audio scores only the
        positions of ``mask_indices``."""
        cfg = self.cfg
        x, prefix_len = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        hidden, aux = self.backbone(x, positions, prefix_len)
        labels = batch["labels"]
        if cfg.frontend == "vision_stub":
            hidden = hidden[:, cfg.n_prefix_tokens:]
        if cfg.frontend == "audio_stub" and "mask_indices" in batch:
            labels = torch.where(batch["mask_indices"], labels, torch.full_like(labels, -1))
        ce = self.chunked_ce(hidden, labels)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------------ #
    # serving: prefill + decode                                          #
    # ------------------------------------------------------------------ #
    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """Name -> (shape, dtype) of every leaf of the whole decode cache
        (the reference's ``cache_init``)."""
        cfg = self.cfg
        cd = _dtype(cfg.compute_dtype)
        if self.attention:
            shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return {"k": (shape, cd), "v": (shape, cd)}
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        out = {"ssm_conv": ((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), cd),
               "ssm_state": ((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), torch.float32)}
        if self.shared is not None:
            napp = cfg.n_layers // cfg.shared_attn_every
            shape = (napp, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            out.update(shared_k=(shape, cd), shared_v=(shape, cd))
        return out

    def cache_plan(self, batch: int, max_len: int, mesh) -> dict:
        """Name -> (this rank's shape, dtype) of every cache leaf under
        ``cache_shardings`` on ``mesh`` (``mesh`` a Mesh or a dict of axis
        sizes; the whole shapes without one)."""
        shapes = self.cache_shapes(batch, max_len)
        if mesh is None:
            return shapes
        plan = sharding.cache_shardings({k: s for k, (s, _) in shapes.items()}, mesh,
                                        batch=batch)
        return {k: (sharding.local_shape(s, plan[k], mesh), dt) for k, (s, dt) in shapes.items()}

    def cache_init(self, batch: int, max_len: int) -> dict:
        """The zero decode cache for ``batch`` sequences of up to ``max_len``
        positions; for a model sharded over the current mesh, this rank's
        part of ``cache_shardings``' plan (``batch`` the global batch)."""
        mesh = dist_api.current() if self.placement is not None else None
        cache: dict = {"pos": 0}
        for k, (shape, dt) in self.cache_plan(batch, max_len, mesh).items():
            cache[k] = torch.zeros(shape, dtype=dt, device=self.device)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One decode step. tokens (B, 1) -> logits (B, V); the cache is
        updated in place and returned.  Under a mesh ``tokens`` are the
        rank's data shard's (B_loc, 1), as prefill's logits are."""
        self._check_mesh()
        cfg = self.cfg
        w = self.weights()
        x = self.embed_tokens(tokens)                     # (B, 1, d)
        pos = int(cache["pos"])

        def attn(x, blk, k_cache, v_cache, window):
            x = x + attention_decode(rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn, k_cache,
                                     v_cache, pos, cfg, window)
            return x + self._ffn(rms_norm(x, blk.ln2, cfg.norm_eps), blk)[0]

        for idx, layer in enumerate(w.layers):
            if self.attention:
                x = attn(x, layer, cache["k"][idx], cache["v"][idx], self.layer_window(idx))
                continue
            ln1, p = layer
            out, sc = ssm_mod.ssm_decode_step(
                rms_norm(x, ln1, cfg.norm_eps), p,
                ssm_mod.SSMCache(conv=cache["ssm_conv"][idx], state=cache["ssm_state"][idx]),
                cfg)
            x = x + out
            cache["ssm_conv"][idx] = sc.conv
            cache["ssm_state"][idx] = sc.state
            if self._applies_shared(idx):
                app = (idx + 1) // cfg.shared_attn_every - 1
                x = attn(x, w.shared, cache["shared_k"][app], cache["shared_v"][app], 0)
        x = rms_norm(x, w.final_norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return self.logits(x)[:, 0], cache

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
        """Process a full prompt (vlm: patches, then text); returns the last
        position's logits (B, V) and the cache, ``pos`` = the prompt's length
        with its prefix.  Under a mesh ``batch`` is the global batch: the
        rank computes on its rows and returns their logits (B_loc, V) and
        its part of the cache."""
        self._check_mesh()
        b_all = next(iter(batch.values())).shape[0]
        if self.placement is not None:
            batch = sharding.shard_batch(batch, dist_api.current())
        x, prefix_len = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self.cache_init(b_all, max_len)
        x, _ = self.backbone(x, positions, prefix_len, cache)
        cache["pos"] = s
        return self.logits(x[:, -1:])[:, 0], cache
