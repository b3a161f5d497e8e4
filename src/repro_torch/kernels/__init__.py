"""Hand-written CUDA kernels for Hopper, one subpackage per Pallas kernel.

Each subpackage keeps the triple of ``repro.kernels``:
  ref.py    — the plain PyTorch version of the function (any device);
  kernel.py — the ctypes launcher of the CUDA kernel in ``csrc/`` (CUDA
              tensors only; checks its inputs, counts its launches);
  ops.py    — the public wrapper: CPU tensors run ref.py, CUDA tensors
              launch the kernel or raise.  There is no fallback.

Kernels:
  gaussian     — batched Gaussian kernel block (K1)
  compress     — fused assemble + pivoted-QR row ID of one tree level (K2),
                 both kernels; ``compress/laplacian.py`` holds the batched
                 laplacian block (K4) with its launcher and wrapper, and
                 ``compress/verify.py`` the comparison of K2's row IDs with
                 the plain version's where rounding decides a pivot
  admm_update  — fused ADMM z-projection + multiplier update (K3)
  attention    — flash attention: causal, window, prefix, softcap, GQA (K5)
  ssd          — the Mamba-2 SSD chunk scan with its final state (K6)
"""
