"""K1: batched Gaussian kernel block (CUDA twin of repro.kernels.gaussian)."""
