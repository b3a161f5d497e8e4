"""Public attention wrapper: the CUDA kernel on the card, ref.py on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, prefix_len: int = 0) -> torch.Tensor:
    """Attention over q (B, H, S, D), k and v (B, KV, S, D) -> (B, H, S, D).

    The device of the inputs decides: CPU tensors run the plain version,
    CUDA tensors launch the kernel (one launch) or raise.
    """
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, prefix_len=prefix_len)
    return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap, prefix_len=prefix_len)
