"""zamba2-1.2b [hybrid] — Mamba-2 backbone + shared attention block.

[arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
Mamba-2 blocks throughout; ONE weight-shared attention+MLP block applied
every 6 layers (the real model's per-application LoRA adapters are
simplified to shared weights + per-application KV cache slots — DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    shared_attn_every=6,
)
