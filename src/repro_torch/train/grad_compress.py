"""int8 error-feedback gradient compression: the local half of
``repro.train.grad_compress``.

The wire format of the data-parallel gradient reduction is int8 with one
f32 scale per block of 2048 values.  Error feedback (Seide et al. / EF-SGD)
adds the quantization residual back into the next step's gradient, which
makes the compression unbiased over time.  Here: the quantizer, its round
trip and the error-feedback state, on any device; rounding is half to even
(``torch.round``, as ``jnp.round``).  The collective half (the quantized
all-to-all / all-gather reduction) needs torch.distributed: ROADMAP queue 1
item 13.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_MULTI_GPU = "the compressed all-reduce is multi-GPU work: ROADMAP queue 1 item 13"


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


def compressed_psum_local(g_local, axis_name, n_shards, block=2048):
    raise NotImplementedError(_MULTI_GPU)


def make_compressed_allreduce(mesh, axis_name="data", block=2048):
    raise NotImplementedError(_MULTI_GPU)


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
