"""hubert-xlarge [audio] — encoder-only (w2v2 arch), masked cluster prediction.

[arXiv:2106.07447; unverified]
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means cluster codes).
The conv waveform frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, T, 512), projected to d_model. No decode step
(encoder-only) — decode shapes are skipped per DESIGN.md §5.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio_stub",
    frontend_dim=512,
)
