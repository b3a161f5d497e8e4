"""K3: fused ADMM z/mu update (CUDA twin of repro.kernels.admm_update)."""
