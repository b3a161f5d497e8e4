"""K2: fused assemble + pivoted-QR row ID, gaussian (CUDA twin of repro.kernels.compress)."""
