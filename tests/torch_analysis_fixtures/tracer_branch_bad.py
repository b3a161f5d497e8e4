"""Seeded violations of python-branch-on-tensor."""
import torch


class Config:
    window = 0


class Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flag: bool, scale: float, cfg: Config):
        if flag:                          # a Python bool by annotation
            x = x * 2
        if x is None or isinstance(x, tuple):
            return x
        if x.shape[0] > 2 and x.dim() == 2 and x.dtype == torch.float32:
            x = x + 1
        if torch.is_grad_enabled() or cfg.window or scale > 1:
            x = x - 1
        y = x * 2
        if y.sum() > 0:  # VIOLATION
            y = -y
        while x.max() > 1:  # VIOLATION
            x = x / 2
        assert (x >= 0).all()  # VIOLATION
        z = y if y.mean() > 0 else x  # VIOLATION
        if (x - y).abs().amax() < 1e-3:  # VIOLATION
            z = z + 1
        return z


def cold(x):
    if x.sum() > 0:                       # not on the hot set
        return x
    return -x
