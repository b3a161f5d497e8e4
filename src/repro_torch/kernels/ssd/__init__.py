"""K6: the Mamba-2 SSD chunk scan (CUDA twin of repro.kernels.ssd)."""
