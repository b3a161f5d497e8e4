"""Kernel functions evaluated block-wise (counterpart of ``repro.core.kernelfn``).

The Gaussian kernel K(x, y) = exp(-||x-y||^2 / (2 h^2)) is the paper's
choice; the laplacian kernel exp(-||x-y||_1 / h) is the optional variant.
Block evaluation is the compute hot spot of HSS compression (leaf blocks,
couplings) and of prediction (test × support blocks); every block goes
through ``kernels.gaussian.ops.gaussian_block`` (K1) or
``kernels.compress.laplacian.laplacian_block`` (K4) — the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.  There is no backend
switch: the device of the tensors decides.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.compress import laplacian as lops
from repro_torch.kernels.gaussian import ops as gops

# The row count of each test×support kernel block kept live during scoring.
DEFAULT_SCORE_BLOCK = 2048


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A positive-definite kernel with a single bandwidth-like parameter h."""

    name: str = "gaussian"
    h: float = 1.0

    def __post_init__(self):
        if self.name not in ("gaussian", "laplacian"):
            raise ValueError(f"unknown kernel {self.name!r}")

    def with_h(self, h: float) -> "KernelSpec":
        return dataclasses.replace(self, h=h)


def gaussian_block(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """K(xa, xb) for (ma, f) x (mb, f) -> (ma, mb), or a batch (B, ·, f).

    Distances and exp run in f32; the block comes back in the input type.
    """
    return gops.gaussian_block(xa, xb, h)


def laplacian_block(xa: torch.Tensor, xb: torch.Tensor, h: float) -> torch.Tensor:
    """exp(-||xa - xb||_1 / h) for (ma, f) x (mb, f) -> (ma, mb), or a batch.

    Follows the reference's Pallas kernel, not ``laplacian_block_xla``: the
    L1 distance is summed in f32 whatever the input type, multiplied by
    f32(1/h), and the block comes back in the input type.
    """
    return lops.laplacian_block(xa, xb, h)


def kernel_block(spec: KernelSpec, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Evaluate a (len(xa), len(xb)) kernel block (or a batch) under ``spec``."""
    if spec.name == "laplacian":
        return laplacian_block(xa, xb, spec.h)
    return gaussian_block(xa, xb, spec.h)


def kernel_matvec_streamed(
    spec: KernelSpec, x_rows: torch.Tensor, x_cols: torch.Tensor, v: torch.Tensor,
    block: int = DEFAULT_SCORE_BLOCK,
) -> torch.Tensor:
    """K(x_rows, x_cols) @ v without materializing more than one row block.

    Walks the rows in blocks of ``block`` — O(block · n_cols) live memory,
    one kernel-block launch per row block.  ``v`` may be (n_cols,) or
    (n_cols, k); the product accumulates in f32 (TF32 stays off).  A bf16
    block and bf16 coefficients are widened as they enter the product (each
    exact in f32): the reference's bf16×bf16 contraction with
    ``preferred_element_type=float32``.
    """
    return torch.cat([kernel_block(spec, x_rows[i:i + block], x_cols).float() @ v.float()
                      for i in range(0, x_rows.shape[0], block)], dim=0)
