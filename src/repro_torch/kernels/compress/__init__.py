"""K2: fused assemble + pivoted-QR row ID, gaussian and laplacian, and K4: the
batched laplacian block (CUDA twins of repro.kernels.compress)."""
