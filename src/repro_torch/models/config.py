"""Model configuration schema (a copy of ``repro.models.config``).

The port keeps the same fields so that a configuration means the same model
in both packages.  ``use_pallas`` is kept for that reason only: in the port
the device of the tensors decides whether a kernel runs (CUDA tensors launch
K5/K6, CPU tensors run their plain versions).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                   # dense-FFN hidden size (per-expert size for moe)
    vocab: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0       # arctic: parallel dense residual FFN width
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4

    # --- attention behaviour ---
    causal: bool = True
    window: int = 0             # >0: local window size for local layers
    alt_local_global: bool = False   # gemma-2: even layers local, odd global
    attn_softcap: float = 0.0        # gemma-2: 50.0
    final_softcap: float = 0.0       # gemma-2: 30.0

    # --- hybrid (zamba-2) ---
    shared_attn_every: int = 0  # apply the shared attention block every k layers

    # --- modality frontend stubs ---
    frontend: str = "none"      # none | audio_stub | vision_stub
    frontend_dim: int = 0       # stub embedding dim (conv-stem/SigLIP output)
    n_prefix_tokens: int = 0    # vlm: number of patch tokens prepended

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # implementation knobs
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    ssd_chunk: int = 128
    loss_chunk: int = 512
    remat: str = "block"        # none | block  (activation checkpointing)
    use_pallas: bool = False    # the reference's TPU switch; unread in the port

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_decoder(self) -> bool:
        return self.family not in ("encoder",)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """long_500k runs only for sub-quadratic-decode-state families."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized config of the same family (see configs/*)."""
        base = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab=256,
        )
        if self.n_experts:
            base.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.moe_dense_ff:
            base.update(moe_dense_ff=128)
        if self.family in ("ssm", "hybrid"):
            base.update(ssm_state=16, ssm_head_dim=16)
        if self.frontend != "none":
            base.update(frontend_dim=32, n_prefix_tokens=min(self.n_prefix_tokens, 8) or 0)
        if self.window:
            base.update(window=16)
        if self.shared_attn_every:
            base.update(shared_attn_every=2)
        base.update(overrides)
        return dataclasses.replace(self, **base)
