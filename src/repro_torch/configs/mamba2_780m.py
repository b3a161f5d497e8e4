"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]
48L d_model=1536 (attn-free) vocab=50280, ssm_state=128.
expand=2 -> d_inner=3072, head_dim=64 -> 48 SSD heads, 1 B/C group.

The paper-representative architecture: SSD's token-mixing operator is a
1-semiseparable matrix evaluated with the same dense-diagonal + low-rank
off-diagonal split the paper's HSS uses (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
)
