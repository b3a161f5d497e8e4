"""Public attention wrapper: the CUDA kernel on the card, ref.py on the CPU.

Under autograd the call is a ``torch.autograd.Function``: its forward is the
same launch (or, on the CPU, the same plain version) and saves q, k and v;
its backward recomputes the plain version, ``ref.attention_ref``, and
returns that function's gradient.  The backward is the one place where the
plain version runs on a card path: K5 has no backward kernel yet (ROADMAP
queue 2), and the JAX package has none either, it trains by differentiating
its plain ``chunked_attention``.  The forward never gives way to it.

Meta tensors (the dry run, ``launch/dryrun.py``) launch nothing: the call
returns the output's shape and ``kernels.cost.record``s the kernel's work
(``k5_work``), which the dry run's op counter adds to what it counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.attention import kernel, ref


def _meta(q, k, v, opts):
    b, h, s, d = q.shape
    pairs = cost.visible_pairs(s, opts["causal"], opts["window"], opts["prefix_len"])
    cost.record("flash_attention", cost.k5_work(b, h, k.shape[1], s, d, q.element_size(),
                                                pairs))
    return torch.empty_like(q)


def _forward(q, k, v, opts):
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **opts)
    if q.device.type == "meta":
        return _meta(q, k, v, opts)
    return kernel.flash_attention_cuda(q, k, v, **opts)


class _Attention(torch.autograd.Function):
    """K5 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        return _forward(q, k, v, opts)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = ref.attention_ref(*inputs, **ctx.opts)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, prefix_len: int = 0) -> torch.Tensor:
    """Attention over q (B, H, S, D), k and v (B, KV, S, D) -> (B, H, S, D).

    The device of the inputs decides: CPU tensors run the plain version,
    CUDA tensors launch the kernel (one launch) or raise, meta tensors
    record its work and compute nothing.  Where autograd
    records (grad mode on, an input requiring grad) the backward is the
    plain version's gradient; without it the call is exactly the launch.
    """
    opts = dict(causal=causal, window=window, softcap=softcap, prefix_len=prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, opts)
    return _forward(q, k, v, opts)
