"""Model assembly of the port: init, prefill, decode for the ssm / hybrid families.

Twin of ``repro.models.transformer.Model`` as an ``nn.Module``.  The
reference stacks every per-layer leaf along a leading (L,) axis and scans;
here each layer is a submodule of its own and the scan is a Python loop.

  ssm     — Mamba-2 SSD blocks only                (mamba2)
  hybrid  — Mamba-2 blocks + ONE shared attention+MLP block applied after
            every layer idx with (idx + 1) % shared_attn_every == 0
            (zamba2; its weights are reused at each application, with a
            KV cache slot per application)

The other families (dense, moe, encoder, vlm) are ROADMAP queue 1 item 14
and raise ``NotImplementedError``.

Parameters are kept in ``param_dtype`` (f32 masters).  Like the
reference's ``_cast_tree``, every float parameter enters the compute in
``compute_dtype`` — ``a_log``, ``d_skip`` and ``dt_bias`` included, which
under bf16 rounds them before ``ssm_block`` widens them again.  The cast
copies are made once, at the first forward, and kept (the cast is exact
to repeat); ``init`` drops them.  Serving updates the cache dict in place.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnParams, MLPParams, apply_rope, attention_block,
                                       decode_attention, mlp_block, qkv, rms_norm)

FAMILIES = ("ssm", "hybrid")

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


class SharedBlock(nn.Module):
    """zamba2's weight-shared attention + MLP block."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.ln1 = _param((d,), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self.wq = _param((d, cfg.n_heads * hd), dtype, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _param((cfg.n_heads * hd, d), dtype, device)
        self.w_gate = _param((d, cfg.d_ff), dtype, device)
        self.w_up = _param((d, cfg.d_ff), dtype, device)
        self.w_down = _param((cfg.d_ff, d), dtype, device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves the ssm and hybrid families; "
                "the others are ROADMAP queue 1 item 14")
        if cfg.frontend != "none":
            raise NotImplementedError("modality frontends are ROADMAP queue 1 item 14")
        self.cfg = cfg
        self.device = torch.device(device)
        pd = _dtype(cfg.param_dtype)
        d = cfg.d_model
        self.embed = _param((cfg.vocab, d), pd, self.device)
        self.final_norm = _param((d,), pd, self.device)
        self.head = None if cfg.tie_embeddings else _param((d, cfg.vocab), pd, self.device)
        self.layers = nn.ModuleList(SSMLayer(cfg, pd, self.device)
                                    for _ in range(cfg.n_layers))
        self.shared = (SharedBlock(cfg, pd, self.device)
                       if cfg.family == "hybrid" and cfg.shared_attn_every else None)
        self._cw = None

    # ------------------------------------------------------------------ #
    # init                                                               #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` with the reference's
        distributions (``transformer.py`` ``Model.init``): matrices normal
        times shape[-2]^-1/2 (the embedding 0.02), gains and biases zero,
        ``a_log = log(linspace(1, 16, H))``, ``d_skip`` one, and ``dt_bias``
        the inverse softplus of exp(uniform(log 1e-3, log 1e-1))."""
        cfg = self.cfg
        gdev = generator.device

        def normal(p: nn.Parameter, scale: float):
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev) * scale)

        def mat(p: nn.Parameter):
            normal(p, p.shape[-2] ** -0.5)

        normal(self.embed, 0.02)
        if self.head is not None:
            mat(self.head)
        heads = cfg.ssm_heads
        lo, hi = math.log(1e-3), math.log(1e-1)
        for layer in self.layers:
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
            for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                mat(getattr(self.shared, w))
            self.shared.ln1.zero_()
            self.shared.ln2.zero_()
        self.final_norm.zero_()
        self._cw = None
        return self

    def weights(self) -> SimpleNamespace:
        """Every parameter in the compute type (``_cast_tree``), made once."""
        if self._cw is None:
            cd = _dtype(self.cfg.compute_dtype)
            c = lambda p: p.detach().to(cd)
            sh = self.shared
            self._cw = SimpleNamespace(
                embed=c(self.embed), final_norm=c(self.final_norm),
                head=c(self.embed).T if self.head is None else c(self.head),
                layers=[(c(lay.ln1), ssm_mod.SSMParams(
                    *(c(getattr(lay, f)) for f in ssm_mod.SSMParams._fields)))
                    for lay in self.layers],
                shared=None if sh is None else SimpleNamespace(
                    ln1=c(sh.ln1), ln2=c(sh.ln2),
                    attn=AttnParams(*(c(getattr(sh, f)) for f in AttnParams._fields)),
                    mlp=MLPParams(*(c(getattr(sh, f)) for f in MLPParams._fields))))
        return self._cw

    # ------------------------------------------------------------------ #
    # embedding / unembedding                                            #
    # ------------------------------------------------------------------ #
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.weights().embed
        # the reference multiplies by a weakly typed scalar: it is rounded
        # to the compute type first
        return emb[tokens] * torch.tensor(self.cfg.d_model ** 0.5, dtype=emb.dtype)

    def embed_inputs(self, batch: dict) -> tuple[torch.Tensor, int]:
        """(x (B, S, d), prefix_len) for a batch of ``tokens`` (no frontend)."""
        return self.embed_tokens(batch["tokens"]), 0

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out = (x @ self.weights().head).float()
        if cfg.final_softcap > 0:
            out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
        return out

    # ------------------------------------------------------------------ #
    # forward                                                            #
    # ------------------------------------------------------------------ #
    def _applies_shared(self, idx: int) -> bool:
        every = self.cfg.shared_attn_every
        return self.shared is not None and bool(every) and (idx + 1) % every == 0

    def _block(self, x, layer):
        """One Mamba-2 layer with its residual (the ssm/hybrid ``_block``;
        these families have no per-layer attention, so no layer window)."""
        ln1, p = layer
        return x + ssm_mod.ssm_block(rms_norm(x, ln1, self.cfg.norm_eps), p, self.cfg)

    def _shared_block(self, x, positions, prefix_len, kv_out=None):
        """The shared attention + MLP block; ``kv_out`` receives the (k, v)
        the attention used (prefill's cache)."""
        cfg, sw = self.cfg, self.weights().shared
        h = rms_norm(x, sw.ln1, cfg.norm_eps)
        q, k, v = qkv(h, sw.attn, positions, cfg)
        if kv_out is not None:
            kv_out.extend((k, v))
        x = x + attention_block(h, sw.attn, positions, cfg, 0, prefix_len, kv=(q, k, v))
        return x + mlp_block(rms_norm(x, sw.ln2, cfg.norm_eps), sw.mlp)

    def backbone(self, x: torch.Tensor, positions: torch.Tensor,
                 prefix_len: int = 0) -> torch.Tensor:
        """Every layer in order. Returns the final-normed hidden (B, S, d)."""
        w = self.weights()
        for idx, layer in enumerate(w.layers):
            x = self._block(x, layer)
            if self._applies_shared(idx):
                x = self._shared_block(x, positions, prefix_len)
        return rms_norm(x, w.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def forward_logits(self, batch: dict) -> torch.Tensor:
        """Full-sequence logits (B, S, V) f32."""
        x, prefix_len = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        return self.logits(self.backbone(x, positions, prefix_len))

    # ------------------------------------------------------------------ #
    # serving: prefill + decode                                          #
    # ------------------------------------------------------------------ #
    def cache_init(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        cd = _dtype(cfg.compute_dtype)
        dev = self.device
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache: dict = {
            "pos": 0,
            "ssm_conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                                    dtype=cd, device=dev),
            "ssm_state": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim), dtype=torch.float32, device=dev),
        }
        if self.shared is not None:
            napp = cfg.n_layers // cfg.shared_attn_every
            shape = (napp, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache["shared_k"] = torch.zeros(shape, dtype=cd, device=dev)
            cache["shared_v"] = torch.zeros(shape, dtype=cd, device=dev)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One decode step. tokens (B, 1) -> logits (B, V); the cache is
        updated in place and returned."""
        cfg = self.cfg
        w = self.weights()
        x = self.embed_tokens(tokens)                     # (B, 1, d)
        pos = int(cache["pos"])
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
        for idx, (ln1, p) in enumerate(w.layers):
            hn = rms_norm(x, ln1, cfg.norm_eps)
            out, sc = ssm_mod.ssm_decode_step(
                hn, p, ssm_mod.SSMCache(conv=cache["ssm_conv"][idx],
                                        state=cache["ssm_state"][idx]), cfg)
            x = x + out
            cache["ssm_conv"][idx] = sc.conv
            cache["ssm_state"][idx] = sc.state
            if self._applies_shared(idx):
                app = (idx + 1) // cfg.shared_attn_every - 1
                x = x + self._attn_decode(rms_norm(x, w.shared.ln1, cfg.norm_eps),
                                          w.shared.attn, cache["shared_k"][app],
                                          cache["shared_v"][app], pos, positions, 0)
                x = x + mlp_block(rms_norm(x, w.shared.ln2, cfg.norm_eps), w.shared.mlp)
        x = rms_norm(x, w.final_norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return self.logits(x)[:, 0], cache

    def _attn_decode(self, h, ap, k_cache, v_cache, pos, positions, window):
        """One token's attention; writes its k and v at ``pos`` in place."""
        cfg = self.cfg
        b = h.shape[0]
        bq = apply_rope((h @ ap.wq).reshape(b, 1, cfg.n_heads, cfg.head_dim),
                        positions, cfg.rope_theta)
        bk = apply_rope((h @ ap.wk).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim),
                        positions, cfg.rope_theta)
        bv = (h @ ap.wv).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        k_cache[:, pos] = bk[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = bv[:, 0].to(v_cache.dtype)
        cur = torch.full((b,), pos + 1, dtype=torch.long, device=h.device)
        out = decode_attention(bq, k_cache, v_cache, cur, softcap=cfg.attn_softcap,
                               window=window)
        return out.reshape(b, 1, -1) @ ap.wo

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
        """Process a full prompt; returns (last-token logits (B, V), cache)."""
        x, prefix_len = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        return self._prefill_ssm(x, positions, prefix_len, self.cache_init(b, max_len))

    def _prefill_ssm(self, x, positions, prefix_len, cache):
        """SSM / hybrid prefill: fills the SSD states, the conv tails and the
        shared block's K/V slots."""
        cfg = self.cfg
        w = self.weights()
        s = x.shape[1]
        for idx, (ln1, p) in enumerate(w.layers):
            out, sc = ssm_mod.ssm_block(rms_norm(x, ln1, cfg.norm_eps), p, cfg,
                                        return_cache=True)
            x = x + out
            cache["ssm_conv"][idx] = sc.conv
            cache["ssm_state"][idx] = sc.state
            if self._applies_shared(idx):
                app = (idx + 1) // cfg.shared_attn_every - 1
                kv: list = []
                x = self._shared_block(x, positions, prefix_len, kv_out=kv)
                cache["shared_k"][app, :, :s] = kv[0]
                cache["shared_v"][app, :, :s] = kv[1]
        x = rms_norm(x, w.final_norm, cfg.norm_eps)
        cache["pos"] = s
        return self.logits(x[:, -1:])[:, 0], cache
