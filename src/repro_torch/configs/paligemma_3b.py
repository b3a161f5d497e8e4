"""paligemma-3b [vlm] — SigLIP patch prefix + gemma text backbone.

[arXiv:2407.07726; hf]
18L d_model=2048 8H (GQA kv=1 — MQA) d_ff=16384 vocab=257216.
The SigLIP tower is a STUB: input_specs() provides 256 precomputed patch
embeddings (dim 1152), linearly projected and prepended as a fully-visible
prefix (prefix-LM mask); text is causal.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    frontend="vision_stub",
    frontend_dim=1152,
    n_prefix_tokens=256,
)
