"""Torch code that every rule passes: the sanctioned spellings."""
import numpy as np
import torch


class Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n: int, gen: torch.Generator):
        if x is None or x.shape[0] < n or not torch.is_grad_enabled():
            return x
        y = torch.einsum("ij,jk->ik", x.float(), x.T)
        z = torch.mm(x, x, out_dtype=torch.float32)
        c, info = torch.linalg.cholesky_ex(y)
        c = torch.where((info == 0)[..., None, None], c, torch.nan)
        r = x.repeat_interleave(2, dim=0)
        noise = torch.randn(x.shape, generator=gen)
        keep = torch.where(x > 0, x, torch.zeros_like(x))
        return y + z + c + noise[: y.shape[0]], r, keep

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def host_side(x):
    rng = np.random.default_rng(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return x.item() + rng.normal(), x[x > 0]
