"""gemma2-9b [dense] — alternating local/global attention + logit softcaps.

[arXiv:2408.00118; hf]
42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Even layers: sliding window 4096; odd layers: global.  Attention logits
softcapped at 50, final logits at 30.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
)
