"""K5: flash attention (CUDA twin of repro.kernels.attention)."""
