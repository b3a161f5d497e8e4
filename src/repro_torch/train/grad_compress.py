"""int8 error-feedback gradient compression for the data-parallel
all-reduce (twin of ``repro.train.grad_compress``).

The wire format of the data-parallel gradient reduction is int8 with one
f32 scale per block of 2048 values: a reduce-scatter expressed as an
all_to_all of QUANTIZED chunks (each rank receives every peer's int8 chunk
of its own index, dequantizes and sums them), then an all_gather of the
re-quantized reduced chunk, over ``dist.api``'s collectives (``Mesh.stats``
counts the int8 codes and the f32 scales that cross).  Error feedback
(Seide et al. / EF-SGD) adds the quantization residual back into the next
step's gradient, which makes the compression unbiased over time.  Rounding
is half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import api as dist_api

def _quantize(x: torch.Tensor, block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block int8 quantization. x flat (N,) -> (q int8 (blocks, block),
    scales f32 (blocks,))."""
    n = x.shape[0]
    xp = F.pad(x, (0, (-n) % block)).reshape(-1, block)
    scale = torch.clamp(xp.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale[:, None]).reshape(-1)[:n]


def compress_roundtrip(x: torch.Tensor, block: int = 2048) -> torch.Tensor:
    q, s = _quantize(x, block)
    return _dequantize(q, s, x.shape[0])


def compressed_psum_local(g_local: torch.Tensor, axis_name: str, n_shards: int,
                          block: int = 2048, mesh=None) -> torch.Tensor:
    """Quantized all-reduce over ``axis_name`` of the current mesh (or
    ``mesh``): every rank passes its flat ``g_local`` (N,), N divisible by
    ``n_shards`` (the axis's size), and receives the sum.

    Chunk i of each rank is quantized and sent to rank i (all_to_all of the
    codes and of the scales), each rank dequantizes what it got and sums it
    in rank order, re-quantizes the sum, and one all_gather of codes and
    scales gives every rank every reduced chunk.  Wire traffic per rank:
    N int8 bytes and the scales, twice."""
    n = g_local.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} values do not split into {n_shards} chunks")
    c = n // n_shards
    chunks = g_local.float().reshape(n_shards, c)
    qs = [_quantize(chunks[i], block) for i in range(n_shards)]
    q = torch.stack([a for a, _ in qs])                     # (n, blocks, block) int8
    s = torch.stack([b for _, b in qs])                     # (n, blocks) f32
    q_all = dist_api.all_to_all(q, axis_name, 0, 0, mesh)   # row j: rank j's chunk of mine
    s_all = dist_api.all_to_all(s, axis_name, 0, 0, mesh)
    reduced = _dequantize(q_all[0], s_all[0], c)
    for j in range(1, n_shards):
        reduced = reduced + _dequantize(q_all[j], s_all[j], c)
    q_r, s_r = _quantize(reduced, block)
    q_full = dist_api.all_gather(q_r[None], axis_name, 0, mesh)      # (n, blocks, block)
    s_full = dist_api.all_gather(s_r[None], axis_name, 0, mesh)
    return torch.cat([_dequantize(q_full[j], s_full[j], c) for j in range(n_shards)])


def make_compressed_allreduce(mesh, axis_name: str = "data", block: int = 2048):
    """Returns f(g_local (N,)) -> the compressed sum (N,) over ``axis_name``
    of ``mesh``: each rank calls it with its own flat gradient (the
    reference's takes the stacked (n_shards, N) array of one controller)."""
    n_shards = dist_api.axis_size(axis_name, mesh)

    def reduce_fn(g_local: torch.Tensor) -> torch.Tensor:
        return compressed_psum_local(g_local, axis_name, n_shards, block, mesh)

    return reduce_fn


class ErrorFeedback:
    """g_compressed = Q(g + e);  e' = (g + e) - Q(g + e), over dicts of tensors."""

    @staticmethod
    def init(params: dict) -> dict:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    @staticmethod
    def apply(grads: dict, err: dict, block: int = 2048) -> tuple[dict, dict]:
        comp, new_err = {}, {}
        for k, g in grads.items():
            target = g.float() + err[k]
            c = compress_roundtrip(target.reshape(-1), block).reshape(g.shape)
            comp[k], new_err[k] = c.to(g.dtype), target - c
        return comp, new_err
