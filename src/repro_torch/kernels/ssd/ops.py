"""Public SSD wrapper: the CUDA kernel on the card, ref.py on the CPU.

Under autograd the call is a ``torch.autograd.Function``: its forward is the
same launch (or, on the CPU, the same plain version) and saves its inputs;
its backward recomputes the plain version, ``ref.ssd_chunked_ref``, and
returns that function's gradient.  The backward is the one place where the
plain version runs on a card path: K6 has no backward kernel yet (ROADMAP
queue 2), and the JAX package trains by differentiating its plain chunk loop
(``repro.models.ssm``, ``use_pallas=False``).  The forward never gives way
to it.

Meta tensors (the dry run, ``launch/dryrun.py``) launch nothing: the call
returns y's shape (and the state's) and ``kernels.cost.record``s the
kernel's work (``k6_work``), which the dry run's op counter adds to what it
counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.ssd import kernel, ref


def _meta(args, chunk, return_state):
    x, _, _, b_mat = args[:4]
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    cost.record("ssd_chunk", cost.k6_work(bsz, s, h, p, g, n, chunk, x.element_size()))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    return (y, state) if return_state else y


def _forward(args, chunk, return_state):
    if args[0].device.type == "cpu":
        y, h = ref.ssd_chunked_ref(*args, chunk)
        return (y, h) if return_state else y
    if args[0].device.type == "meta":
        return _meta(args, chunk, return_state)
    return kernel.ssd_chunk_cuda(*args, chunk, return_state)


class _SSD(torch.autograd.Function):
    """K6 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, chunk, return_state, *args):
        ctx.save_for_backward(*args)
        ctx.chunk = chunk
        return _forward(args, chunk, return_state)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ref.ssd_chunked_ref(*inputs, ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in inputs))


def ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, d_vec: torch.Tensor,
                chunk: int = 128, return_state: bool = False):
    """The SSD chunk scan in the model layout: x (B, S, H, P), dt (B, S, H)
    (post-softplus), a (H,) negative, b_mat/c_mat (B, S, G, N), d_vec (H,).
    x, B and C may be the model's bf16 (or f32) views; dt, a and D are f32.

    Returns y (B, S, H, P) f32, and with ``return_state`` also the final
    states (B, H, N, P) f32.  CPU tensors run the plain version, which widens
    its inputs to f32 itself; CUDA tensors launch the kernel (three CUDA
    kernels, counted as one launch) or raise; meta tensors record its work
    and compute nothing.  Where autograd records (grad
    mode on, an input requiring grad) the backward is the plain version's
    gradient; without it the call is exactly the launch.
    """
    args = (x, dt, a, b_mat, c_mat, d_vec)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SSD.apply(chunk, return_state, *args)
    return _forward(args, chunk, return_state)
